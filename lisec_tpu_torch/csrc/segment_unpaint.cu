// Segment unpaint for Hopper: per-row gather from a dense per-cell table.
//
// Replaces lisec_tpu/ops/pallas/unpaint.py::segment_unpaint (body
// _unpaint_kernel). The wrapper, its bound and the design notes are in
// lisec_tpu_torch/ops/cuda/segment_unpaint.py.
//
//   out[b, i, :] = table[b, cell[b, i], :C]   if 0 <= cell[b, i] < R
//                  0                          otherwise
//
// One thread owns one output element (or four, on the float4 path): it
// reads its row's cell id, then copies its channel(s) of that table row.
// Every output element is written exactly once by its owner, the zero rows
// of invalid ids included, so blocks may run in any order and nothing is
// patched afterwards.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// VEC = 1: one float per thread; VEC = 4: one float4 per thread (needs C a
// multiple of 4 and 16-byte aligned pointers).
template <int VEC>
__global__ void __launch_bounds__(kThreads)
segment_unpaint_kernel(const float* __restrict__ table,  // (B, R, C)
                       const int* __restrict__ cell,     // (B, N)
                       float* __restrict__ out,          // (B, N, C)
                       int n, int r, int c, unsigned long long total) {
  const unsigned long long idx =
      (unsigned long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;                 // total = B * N * C / VEC
  const unsigned cv = (unsigned)(c / VEC);
  const int ch = (int)(idx % cv) * VEC;
  const unsigned long long row = idx / cv;  // b * N + i
  const int b = (int)(row / (unsigned)n);
  const int id = cell[row];
  const bool ok = id >= 0 && id < r;
  const float* src = table + ((size_t)b * r + (ok ? id : 0)) * c + ch;
  float* dst = out + row * (unsigned)c + ch;
  if (VEC == 4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) v = *reinterpret_cast<const float4*>(src);
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    *dst = ok ? *src : 0.0f;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns the cudaError_t of the
// launch; 0 means it was accepted.
extern "C" int lisec_segment_unpaint(const void* table, const void* cell,
                                     void* out, int b, int n, int r, int c,
                                     void* stream) {
  if (b < 1 || n < 1 || r < 1 || c < 1) return (int)cudaErrorInvalidValue;
  const bool vec = c % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned long long total =
      (unsigned long long)b * n * c / (vec ? 4 : 1);
  const unsigned long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647ull) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int* ids = static_cast<const int*>(cell);
  float* o = static_cast<float*>(out);
  if (vec)
    segment_unpaint_kernel<4><<<(unsigned)blocks, kThreads, 0, s>>>(
        t, ids, o, n, r, c, total);
  else
    segment_unpaint_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(
        t, ids, o, n, r, c, total);
  return (int)cudaGetLastError();
}
