// Segment paint for Hopper: cell-sorted rows -> dense per-cell table.
//
// Replaces lisec_tpu/ops/pallas/pillar_paint.py::segment_paint (body
// _paint_kernel). The wrapper, its bound and the design notes are in
// lisec_tpu_torch/ops/cuda/segment_paint.py.
//
// One thread owns one output element (cloud, cell, channel). The rows of a
// cell are contiguous after the sort and the wrapper hands in every cell's
// range (offs), so the thread walks rows [offs[cell], offs[cell + 1]) of
// its channel and writes its element once: the running max for channels
// [0, num_max) (-3e38 where the cell is empty), the sum for channels
// [num_max, C) (0 where empty). Neighbouring threads own neighbouring
// channels of one cell, then the next cell, so a warp reads consecutive
// floats of consecutive rows and writes 32 consecutive floats.
//
// The table may be written in two contiguous parts, channels [0, split)
// into out and channels [split, C) into out_tail (split == C: one table,
// out_tail unused), so that a caller's canvas and its count channel come
// out as two dense tensors.
//
// No atomics. A sum is taken in row order in f64 and rounded to f32 once,
// so the same input gives the same bits on every run, and the plain
// PyTorch version (an f64 index_add_ rounded to f32) gives the same bits
// as well.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEmptyMax = -3.0e38f;

__global__ void __launch_bounds__(kThreads)
segment_paint_kernel(const float* __restrict__ vals,  // (B, N, C) by cell
                     const int* __restrict__ offs,    // (B, ncells + 1)
                     float* __restrict__ out,       // (B, ncells, split)
                     float* __restrict__ out_tail,  // (B, ncells, C - split)
                     int n, int ncells, int c, int num_max, int split,
                     unsigned head_blocks) {
  // blockIdx.y is the cloud. Of a cloud's blocks the first head_blocks
  // own out, the rest out_tail; within a part the threads are numbered in
  // its memory order, in 32 bits (64-bit divisions per thread cost this
  // kernel more than its stores).
  const int b = blockIdx.y;
  const bool tail = blockIdx.x >= head_blocks;
  const unsigned width = tail ? (unsigned)(c - split) : (unsigned)split;
  const unsigned idx =
      (blockIdx.x - (tail ? head_blocks : 0u)) * kThreads + threadIdx.x;
  if (idx >= (unsigned)ncells * width) return;
  const int cell = (int)(idx / width);
  const int ch = (tail ? split : 0) + (int)(idx % width);
  float* dst = (tail ? out_tail : out) + (size_t)b * ncells * width + idx;

  const int* ob = offs + (size_t)b * (ncells + 1);
  const int start = ob[cell];
  const int end = ob[cell + 1];
  const float* v = vals + ((size_t)b * n + start) * c + ch;
  const int len = end - start;
  float res;
  if (ch < num_max) {
    float m = kEmptyMax;
    for (int i = 0; i < len; ++i) m = fmaxf(m, v[(size_t)i * c]);
    res = m;
  } else {
    double s = 0.0;
    for (int i = 0; i < len; ++i) s += (double)v[(size_t)i * c];
    res = (float)s;
  }
  *dst = res;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns the cudaError_t of the
// launch; 0 means it was accepted.
extern "C" int lisec_segment_paint(const void* vals, const void* offs,
                                   void* out, void* out_tail, int b, int n,
                                   int ncells, int c, int num_max, int split,
                                   void* stream) {
  if (b < 1 || n < 0 || ncells < 1 || c < 1 || num_max < 0 || num_max > c ||
      split < 1 || split > c || (split < c && out_tail == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((unsigned long long)ncells * c >= 2147483648ull || b > 65535)
    return (int)cudaErrorInvalidValue;
  const unsigned long long per = kThreads;
  const unsigned head_blocks =
      (unsigned)(((unsigned long long)ncells * split + per - 1) / per);
  const unsigned tail_blocks =
      (unsigned)(((unsigned long long)ncells * (c - split) + per - 1) / per);
  const dim3 grid(head_blocks + tail_blocks, (unsigned)b);
  segment_paint_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(offs),
      static_cast<float*>(out), static_cast<float*>(out_tail), n, ncells, c,
      num_max, split, head_blocks);
  return (int)cudaGetLastError();
}
