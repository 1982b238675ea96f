// Fused pillar encoder for Hopper: cell-sorted points -> BEV canvas.
//
// Replaces lisec_tpu/ops/pallas/encoder_kernel.py::pillar_canvas_fused
// (body _encoder_kernel). The wrapper, its bound and the design notes are
// in lisec_tpu_torch/ops/cuda/encoder_kernel.py.
//
// One warp owns one (cloud, cell). Lane l owns channels l, l+32, ... of
// the C = 32 * CPL channels. The warp walks the cell's points (they are
// contiguous after the sort), 32 at a time: each lane loads one point as
// a float4, then the warp broadcasts them one by one with shuffles. Every
// lane keeps the running max of its channels' per-point term u and the
// (redundant) xyz sums; the epilogue runs in registers and the lanes
// write one coalesced canvas row. Empty cells write zeros, so every
// element of the output is written exactly once; there are no atomics
// and the result does not depend on scheduling.
//
// The arithmetic uses the _rn intrinsics so that nvcc cannot contract it
// into FMAs: the plain PyTorch version performs the same f32 operations
// in the same order, so the two agree bit for bit up to the order of the
// f64 xyz sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int CPL, typename OutT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
pillar_canvas_kernel(const float4* __restrict__ pts,  // (B, N) by cell
                     const int* __restrict__ offs,    // (B, ncells + 1)
                     const float* __restrict__ w,     // (9, C) BN-folded
                     const float* __restrict__ t,     // (C,)
                     OutT* __restrict__ out,          // (B, ncells, C)
                     int n, int ncells, int nx,
                     float vs0, float vs1, float r0, float r1) {
  constexpr int C = CPL * 32;
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (cell >= ncells) return;

  const int* ob = offs + (size_t)b * (ncells + 1);
  const int start = ob[cell];
  const int end = ob[cell + 1];
  OutT* orow = out + ((size_t)b * ncells + cell) * C;
  if (start >= end) {
#pragma unroll
    for (int k = 0; k < CPL; ++k) orow[lane + 32 * k] = to_out<OutT>(0.0f);
    return;
  }

  // weff folds the absolute-decoration columns of the 9-channel PFN
  // input [x, y, z, r, x, y, z, x, y]: u = [x, y, z, r] @ weff.
  float we0[CPL], we1[CPL], we2[CPL], we3[CPL], umax[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    we0[k] = __fadd_rn(__fadd_rn(w[c], w[4 * C + c]), w[7 * C + c]);
    we1[k] = __fadd_rn(__fadd_rn(w[C + c], w[5 * C + c]), w[8 * C + c]);
    we2[k] = __fadd_rn(w[2 * C + c], w[6 * C + c]);
    we3[k] = w[3 * C + c];
    umax[k] = -INFINITY;
  }
  double sx = 0.0, sy = 0.0, sz = 0.0;

  const float4* pb = pts + (size_t)b * n;
  for (int base = start; base < end; base += 32) {
    const int i = base + lane;
    const float4 p = i < end ? pb[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    const int cnt = min(32, end - base);
    for (int j = 0; j < cnt; ++j) {
      const float x = __shfl_sync(kFull, p.x, j);
      const float y = __shfl_sync(kFull, p.y, j);
      const float z = __shfl_sync(kFull, p.z, j);
      const float r = __shfl_sync(kFull, p.w, j);
      sx += x;
      sy += y;
      sz += z;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const float u = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(x, we0[k]), __fmul_rn(y, we1[k])),
                      __fmul_rn(z, we2[k])),
            __fmul_rn(r, we3[k]));
        umax[k] = fmaxf(umax[k], u);
      }
    }
  }

  // Epilogue: relu(max u - mean @ w[4:7] - center @ w[7:9] + t).
  const float count = (float)(end - start);
  const float mx = __fdiv_rn((float)sx, count);
  const float my = __fdiv_rn((float)sy, count);
  const float mz = __fdiv_rn((float)sz, count);
  const float cx = __fadd_rn(
      __fmul_rn(__fadd_rn((float)(cell % nx), 0.5f), vs0), r0);
  const float cy = __fadd_rn(
      __fmul_rn(__fadd_rn((float)(cell / nx), 0.5f), vs1), r1);
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    const float b_mean = __fadd_rn(
        __fadd_rn(__fmul_rn(mx, w[4 * C + c]), __fmul_rn(my, w[5 * C + c])),
        __fmul_rn(mz, w[6 * C + c]));
    const float b_ctr =
        __fadd_rn(__fmul_rn(cx, w[7 * C + c]), __fmul_rn(cy, w[8 * C + c]));
    const float v =
        __fadd_rn(__fsub_rn(__fsub_rn(umax[k], b_mean), b_ctr), t[c]);
    orow[c] = to_out<OutT>(fmaxf(v, 0.0f));
  }
}

template <int CPL, typename OutT>
void launch(const void* pts, const void* offs, const void* w, const void* t,
            void* out, int b, int n, int ncells, int nx, float vs0,
            float vs1, float r0, float r1, cudaStream_t stream) {
  const dim3 grid((ncells + kWarpsPerBlock - 1) / kWarpsPerBlock, b);
  pillar_canvas_kernel<CPL, OutT><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const float4*>(pts), static_cast<const int*>(offs),
      static_cast<const float*>(w), static_cast<const float*>(t),
      static_cast<OutT*>(out), n, ncells, nx, vs0, vs1, r0, r1);
}

template <typename OutT>
int dispatch(const void* pts, const void* offs, const void* w,
             const void* t, void* out, int b, int n, int ncells, int c,
             int nx, float vs0, float vs1, float r0, float r1,
             cudaStream_t s) {
  switch (c / 32) {
    case 1: launch<1, OutT>(pts, offs, w, t, out, b, n, ncells, nx, vs0, vs1, r0, r1, s); break;
    case 2: launch<2, OutT>(pts, offs, w, t, out, b, n, ncells, nx, vs0, vs1, r0, r1, s); break;
    case 3: launch<3, OutT>(pts, offs, w, t, out, b, n, ncells, nx, vs0, vs1, r0, r1, s); break;
    case 4: launch<4, OutT>(pts, offs, w, t, out, b, n, ncells, nx, vs0, vs1, r0, r1, s); break;
    case 5: launch<5, OutT>(pts, offs, w, t, out, b, n, ncells, nx, vs0, vs1, r0, r1, s); break;
    case 6: launch<6, OutT>(pts, offs, w, t, out, b, n, ncells, nx, vs0, vs1, r0, r1, s); break;
    case 7: launch<7, OutT>(pts, offs, w, t, out, b, n, ncells, nx, vs0, vs1, r0, r1, s); break;
    case 8: launch<8, OutT>(pts, offs, w, t, out, b, n, ncells, nx, vs0, vs1, r0, r1, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns the cudaError_t of
// the launch; 0 means it was accepted.
extern "C" int lisec_pillar_canvas_fused(
    const void* pts, const void* offs, const void* w, const void* t,
    void* out, int b, int n, int ncells, int c, int nx, float vs0,
    float vs1, float r0, float r1, int out_bf16, void* stream) {
  if (c % 32 != 0 || c < 32 || c > 256 || b < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return dispatch<__nv_bfloat16>(pts, offs, w, t, out, b, n, ncells, c,
                                   nx, vs0, vs1, r0, r1, s);
  return dispatch<float>(pts, offs, w, t, out, b, n, ncells, c, nx, vs0,
                         vs1, r0, r1, s);
}
