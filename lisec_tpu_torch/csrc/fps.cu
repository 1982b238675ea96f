// Farthest-point sampling for Hopper.
//
// Replaces lisec_tpu/ops/pallas/fps_kernel.py::fps_pallas (bodies
// _fps_batched_kernel and _fps_kernel). The wrapper, its bound and the
// design notes are in lisec_tpu_torch/ops/cuda/fps.py.
//
// For each cloud b, with points (N, 3) f32 and a validity mask (N,):
//
//   out[b, 0] = the lowest valid index, or 0 when no point is valid
//   dist[j]   = 3e38 for a valid point, -3e38 for a masked one
//   for i in 1 .. M-1:
//     dist[j]   = min(dist[j], ((x_j-x_l)^2 + (y_j-y_l)^2) + (z_j-z_l)^2)
//                 for every valid j, l = out[b, i-1]
//     out[b, i] = argmax_j dist[j], the lowest j winning a tie
//
// One thread block owns one cloud for all M rounds: its xyz and running
// min-distance stay in shared memory (16 bytes a point), so a round reads
// nothing from device memory. A round is an update pass, a warp-shuffle
// argmax on (value, index) pairs that prefers the larger value and, on
// equal values, the lower index, and one pass across the warps; two
// barriers a round. The distance is written with __fsub_rn / __fmul_rn /
// __fadd_rn so that nvcc does not contract it into FMAs: the reference
// rounds every product and sum, and one ulp changes an argmax and every
// pick after it.
//
// Bound on the H100: about 10 f32 operations per valid point per round,
// 16 * 2048 * 511 * 10 / 67 TFLOP/s = 2.5 us for PointNet++'s SA1 at batch
// 16; its bytes (the points and mask read once, the picks written once) are
// a twentieth of that. The rounds are sequential, so the kernel is held
// instead by the latency of M block-wide reductions on 16 of the 132 SMs;
// keeping a cloud's state on chip for all rounds is what the design does
// about it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kValid = 3.0e38f;    // initial distance of a valid point
constexpr float kMasked = -3.0e38f;  // distance of a masked point, for good
constexpr unsigned kFull = 0xffffffffu;

// Keep (v, i) or take (v2, i2): the larger value, the lower index on a tie.
__device__ __forceinline__ void take_better(float& v, int& i, float v2,
                                            int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(kFull, v, off);
    const int i2 = __shfl_xor_sync(kFull, i, off);
    take_better(v, i, v2, i2);
  }
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = min(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__global__ void __launch_bounds__(1024)
fps_kernel(const float* __restrict__ points,        // (B, N, 3)
           const unsigned char* __restrict__ mask,  // (B, N) bool
           int* __restrict__ out,                   // (B, M)
           int n, int m) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + n;
  float* zs = ys + n;
  float* dist = zs + n;
  __shared__ float warp_v[32];
  __shared__ int warp_i[32];
  __shared__ int picked;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* p = points + (size_t)blockIdx.x * n * 3;
  const unsigned char* valid = mask + (size_t)blockIdx.x * n;
  int* o = out + (size_t)blockIdx.x * m;

  // Load the cloud; the seed is the lowest valid index.
  int first = n;
  for (int j = tid; j < n; j += blockDim.x) {
    xs[j] = p[3 * j];
    ys[j] = p[3 * j + 1];
    zs[j] = p[3 * j + 2];
    const bool ok = valid[j] != 0;
    dist[j] = ok ? kValid : kMasked;
    if (ok && j < first) first = j;
  }
  first = warp_min(first);
  if (lane == 0) warp_i[warp] = first;
  __syncthreads();
  if (warp == 0) {
    int f = warp_min(lane < nwarps ? warp_i[lane] : n);
    if (lane == 0) {
      picked = f < n ? f : 0;
      o[0] = picked;
    }
  }
  __syncthreads();

  int last = picked;
  for (int i = 1; i < m; ++i) {
    const float lx = xs[last], ly = ys[last], lz = zs[last];
    float bv = -INFINITY;
    int bi = n;
    // j rises within a thread, so a strict > keeps the lowest index.
    for (int j = tid; j < n; j += blockDim.x) {
      float d = dist[j];
      if (d >= 0.0f) {  // valid: masked points hold -3e38 for good
        const float dx = __fsub_rn(xs[j], lx);
        const float dy = __fsub_rn(ys[j], ly);
        const float dz = __fsub_rn(zs[j], lz);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        d = fminf(d, d2);
        dist[j] = d;
      }
      if (d > bv) {
        bv = d;
        bi = j;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      float v = lane < nwarps ? warp_v[lane] : -INFINITY;
      int ix = lane < nwarps ? warp_i[lane] : n;
      warp_argmax(v, ix);
      if (lane == 0) {
        picked = ix;
        o[i] = ix;
      }
    }
    __syncthreads();
    last = picked;
  }
}

}  // namespace

// The most points a cloud may have: four floats a point in shared memory,
// under the 227 KB a block can use beside the kernel's static arrays.
extern "C" int lisec_fps_max_points() { return 14336; }

// Plain C entry point (loaded with ctypes). Returns the cudaError_t of the
// launch; 0 means it was accepted.
extern "C" int lisec_fps(const void* points, const void* mask, void* out,
                         int b, int n, int m, void* stream) {
  if (b < 1 || n < 1 || m < 1 || n > lisec_fps_max_points())
    return (int)cudaErrorInvalidValue;
  const int threads = n >= 1024 ? 1024 : ((n + 31) / 32) * 32;
  const size_t smem = (size_t)n * 4 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fps_kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points),
      static_cast<const unsigned char*>(mask), static_cast<int*>(out), n, m);
  return (int)cudaGetLastError();
}
