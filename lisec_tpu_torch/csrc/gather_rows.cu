// Row gather and its transpose, an ordered row scatter-add, for Hopper.
//
// Replaces lisec_tpu/ops/pallas/gather_mxu.py::gather_rows_mxu (body
// _gather_kernel) and scatter_rows_mxu (body _scatter_kernel). The
// wrappers, their bounds and the design notes are in
// lisec_tpu_torch/ops/cuda/gather_rows.py.
//
// Gather, src (B, N, C) f32 or bf16, idx (B, M) int32:
//
//   out[b, m, :] = src[b, idx[b, m], :]   if 0 <= idx[b, m] < N
//                  0                      otherwise
//
// One owner thread per output element, or per 16 bytes of a row (4 f32 or
// 8 bf16 channels) where C and the pointers allow it; it copies bits, so it
// is exact in both types. Every output element is written once, the zero
// rows of out-of-range ids included. Bound by bytes: the ids, the rows they
// name and the output (the seven gathers of a PointNet++ predict at batch 16
// move 161 MB, 0.048 ms at 3.35 TB/s); the 16-byte owner threads make the
// reads and writes of a row coalesced.
//
// Scatter, vals (B, M, C) f32, the ids' stable sort (B, M) and its row
// ranges offsets (B, R + 1) from the wrapper:
//
//   out[b, r, :] = sum of vals[b, m, :] over m with idx[b, m] = r, in m order
//
// One owner thread per output element (or per 4 channels) walks its row's
// range of the sorted order, which keeps m ascending, adds in f32 and
// writes once, zeros included. No atomics: a run repeats bit for bit, and
// duplicate ids (the ball query's repeat-fill makes them the normal case)
// are summed in the order the TPU kernel's sequential grid adds them. Ids
// outside [0, R) own no range and are dropped. Bound by bytes: the values of
// the rows that land, the ids and the table (154 MB for the three scatters
// of a PointNet++ train step at batch 16, 0.046 ms at 3.35 TB/s); each warp
// reads 32 consecutive channel groups of one value row at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// T: the element (float, or the bits of a bf16); V: what one thread moves
// (T itself, or a 16-byte vector of T).
template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ src,   // (B, N, C)
              const int* __restrict__ idx,  // (B, M)
              T* __restrict__ out,          // (B, M, C)
              int n, int m, int c, unsigned long long total) {
  constexpr int kVec = sizeof(V) / sizeof(T);
  const unsigned long long t =
      (unsigned long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;                   // total = B * M * C / kVec
  const unsigned cv = (unsigned)(c / kVec);
  const int ch = (int)(t % cv) * kVec;
  const unsigned long long row = t / cv;    // b * M + j
  const int b = (int)(row / (unsigned)m);
  const int id = idx[row];
  V v{};
  if (id >= 0 && id < n)
    v = *reinterpret_cast<const V*>(src + ((size_t)b * n + id) * c + ch);
  *reinterpret_cast<V*>(out + row * (unsigned)c + ch) = v;
}

__device__ __forceinline__ void add_to(float& acc, float v) { acc += v; }
__device__ __forceinline__ void add_to(float4& acc, float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// V: float (one channel a thread) or float4 (four).
template <typename V>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const float* __restrict__ vals,   // (B, M, C)
               const int* __restrict__ order,    // (B, M) rows by id, stable
               const int* __restrict__ offsets,  // (B, R + 1)
               float* __restrict__ out,          // (B, R, C)
               int m, int r, int c, unsigned long long total) {
  constexpr int kVec = sizeof(V) / sizeof(float);
  const unsigned long long t =
      (unsigned long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;                   // total = B * R * C / kVec
  const unsigned cv = (unsigned)(c / kVec);
  const int ch = (int)(t % cv) * kVec;
  const unsigned long long row = t / cv;    // b * R + i
  const int b = (int)(row / (unsigned)r);
  const int i = (int)(row % (unsigned)r);
  const int* off = offsets + (size_t)b * (r + 1);
  const int* ord = order + (size_t)b * m;
  const float* v = vals + (size_t)b * m * c + ch;
  V acc{};
  for (int k = off[i], stop = off[i + 1]; k < stop; ++k)
    add_to(acc, *reinterpret_cast<const V*>(v + (size_t)ord[k] * c));
  *reinterpret_cast<V*>(out + row * (unsigned)c + ch) = acc;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, typename V>
int launch_gather(const void* src, const void* idx, void* out, int b, int n,
                  int m, int c, cudaStream_t s) {
  const unsigned long long total =
      (unsigned long long)b * m * c / (sizeof(V) / sizeof(T));
  const unsigned long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647ull) return (int)cudaErrorInvalidValue;
  gather_kernel<T, V><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(src), static_cast<const int*>(idx),
      static_cast<T*>(out), n, m, c, total);
  return (int)cudaGetLastError();
}

template <typename V>
int launch_scatter(const void* vals, const void* order, const void* offsets,
                   void* out, int b, int m, int r, int c, cudaStream_t s) {
  const unsigned long long total =
      (unsigned long long)b * r * c / (sizeof(V) / sizeof(float));
  const unsigned long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647ull) return (int)cudaErrorInvalidValue;
  scatter_kernel<V><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const float*>(vals), static_cast<const int*>(order),
      static_cast<const int*>(offsets), static_cast<float*>(out), m, r, c,
      total);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns the cudaError_t
// of its launch; 0 means it was accepted.

// elem_bytes: 4 for f32, 2 for bf16 (copied as 16-bit words).
extern "C" int lisec_gather_rows(const void* src, const void* idx, void* out,
                                 int b, int n, int m, int c, int elem_bytes,
                                 void* stream) {
  if (b < 1 || n < 1 || m < 1 || c < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (c * elem_bytes) % 16 == 0 && aligned16(src) &&
                   aligned16(out);
  if (elem_bytes == 4)
    return vec ? launch_gather<float, float4>(src, idx, out, b, n, m, c, s)
               : launch_gather<float, float>(src, idx, out, b, n, m, c, s);
  if (elem_bytes == 2)
    return vec ? launch_gather<uint16_t, uint4>(src, idx, out, b, n, m, c, s)
               : launch_gather<uint16_t, uint16_t>(src, idx, out, b, n, m, c,
                                                   s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int lisec_scatter_rows(const void* vals, const void* order,
                                  const void* offsets, void* out, int b,
                                  int m, int r, int c, void* stream) {
  if (b < 1 || m < 1 || r < 1 || c < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % 4 == 0 && aligned16(vals) && aligned16(out))
    return launch_scatter<float4>(vals, order, offsets, out, b, m, r, c, s);
  return launch_scatter<float>(vals, order, offsets, out, b, m, r, c, s);
}
