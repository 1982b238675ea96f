// Spread-accumulate for Hopper: K row streams summed into one dense table.
//
// Replaces lisec_tpu/ops/pallas/spread_kernel.py::spread_accumulate (body
// _spread_kernel). The wrapper, its bound and the design notes are in
// lisec_tpu_torch/ops/cuda/spread_accumulate.py.
//
//   out[b, t, :] = sum over k = 0..K-1, in that order, of
//                  vals[b, k, n, :]  where targets[b, k, n] == t
//
// for vals (B, K, N, C) bf16 or f32 and targets (B, K, N) int32 that name
// each row of [0, num_out) at most once per (b, k); any other id drops its
// row. The result is f32.
//
// Two kernels, no atomics:
//  1. invert: the scratch map in_of (B, K, num_out) is set to -1, then one
//     thread per stream row stores in_of[b, k, targets[b, k, n]] = n. The
//     targets of one (b, k) are distinct, so the stores never collide.
//  2. accumulate: one thread owns VEC neighbouring channels of one output
//     row. It walks k = 0..K-1, reads the row that lands there (if any) and
//     adds it in f32, then writes its channels once, zeros included. The
//     order of the sum is fixed, so a run repeats bit for bit.
// Neighbouring threads own neighbouring channels of one row, then the next
// row: a warp reads whole value rows (16 bytes a thread when C allows) and
// writes consecutive floats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
spread_invert_kernel(const int* __restrict__ targets,  // (B*K, N)
                     int* __restrict__ in_of,          // (B*K, num_out)
                     int n, int num_out, unsigned long long total) {
  const unsigned long long idx =
      (unsigned long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;                 // total = B * K * N
  const int t = targets[idx];
  if (t < 0 || t >= num_out) return;
  const unsigned long long bk = idx / (unsigned)n;
  in_of[bk * (unsigned)num_out + t] = (int)(idx - bk * (unsigned)n);
}

template <typename T, int VEC>
struct Row;

template <int VEC>
struct Row<float, VEC> {
  static __device__ __forceinline__ void add(const float* src, float* acc) {
    if constexpr (VEC == 4) {
      const float4 v = *reinterpret_cast<const float4*>(src);
      acc[0] += v.x; acc[1] += v.y; acc[2] += v.z; acc[3] += v.w;
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += src[i];
    }
  }
};

template <int VEC>
struct Row<__nv_bfloat16, VEC> {
  static __device__ __forceinline__ void add(const __nv_bfloat16* src,
                                             float* acc) {
    if constexpr (VEC == 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p[i]);
        acc[2 * i] += f.x;
        acc[2 * i + 1] += f.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += __bfloat162float(src[i]);
    }
  }
};

// One thread per (cloud, output row, chunk of VEC channels); the threads of
// a cloud are numbered in the output's memory order, in 32 bits.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
spread_accumulate_kernel(const T* __restrict__ vals,     // (B, K, N, C)
                         const int* __restrict__ in_of,  // (B, K, num_out)
                         float* __restrict__ out,        // (B, num_out, C)
                         int k, int n, int c, int num_out) {
  const int b = blockIdx.y;
  const unsigned chunks = (unsigned)(c / VEC);
  const unsigned idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (unsigned)num_out * chunks) return;
  const int t = (int)(idx / chunks);
  const int ch = (int)(idx % chunks) * VEC;

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  const int* map = in_of + (size_t)b * k * num_out + t;
  const T* v = vals + (size_t)b * k * n * c + ch;
  for (int kk = 0; kk < k; ++kk) {
    const int row = map[(size_t)kk * num_out];
    if (row >= 0) Row<T, VEC>::add(v + ((size_t)kk * n + row) * c, acc);
  }
  float* dst = out + ((size_t)b * num_out + t) * c + ch;
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = acc[i];
  }
}

template <typename T, int VEC>
void launch_accumulate(const void* vals, const int* in_of, float* out, int b,
                       int k, int n, int c, int num_out, cudaStream_t s) {
  const unsigned long long per_cloud = (unsigned long long)num_out * (c / VEC);
  const dim3 grid((unsigned)((per_cloud + kThreads - 1) / kThreads),
                  (unsigned)b);
  spread_accumulate_kernel<T, VEC><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(vals), in_of, out, k, n, c, num_out);
}

}  // namespace

// Plain C entry point (loaded with ctypes). vals_bf16 != 0: vals is bf16,
// else f32. in_of is scratch of B * K * num_out ints. Returns the
// cudaError_t of the first call that failed; 0 means all were accepted.
extern "C" int lisec_spread_accumulate(const void* vals, const void* targets,
                                       void* in_of, void* out, int b, int k,
                                       int n, int c, int num_out,
                                       int vals_bf16, void* stream) {
  if (b < 1 || k < 1 || n < 1 || c < 1 || num_out < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  if ((unsigned long long)num_out * c >= 2147483648ull)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* map = static_cast<int*>(in_of);
  float* o = static_cast<float*>(out);

  cudaError_t err = cudaMemsetAsync(
      map, 0xFF, (size_t)b * k * num_out * sizeof(int), s);   // all -1
  if (err != cudaSuccess) return (int)err;
  const unsigned long long rows = (unsigned long long)b * k * n;
  const unsigned long long blocks = (rows + kThreads - 1) / kThreads;
  if (blocks > 2147483647ull) return (int)cudaErrorInvalidValue;
  spread_invert_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const int*>(targets), map, n, num_out, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const bool aligned = reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vals_bf16) {
    if (aligned && c % 8 == 0)
      launch_accumulate<__nv_bfloat16, 8>(vals, map, o, b, k, n, c, num_out, s);
    else
      launch_accumulate<__nv_bfloat16, 1>(vals, map, o, b, k, n, c, num_out, s);
  } else {
    if (aligned && c % 4 == 0)
      launch_accumulate<float, 4>(vals, map, o, b, k, n, c, num_out, s);
    else
      launch_accumulate<float, 1>(vals, map, o, b, k, n, c, num_out, s);
  }
  return (int)cudaGetLastError();
}
