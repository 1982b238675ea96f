// Segment paint for Hopper: cell-sorted rows -> dense per-cell table.
//
// Replaces lisec_tpu/ops/pallas/pillar_paint.py::segment_paint (body
// _paint_kernel). The wrapper, its bound and the design notes are in
// lisec_tpu_torch/ops/cuda/segment_paint.py.
//
// One launch, no glue. A block owns a tile of consecutive cells of one
// cloud. Two warps find the tile's rows [lo, hi) with a 32-way search of
// the sorted ids (ids clamped to ncells first, so an invalid tail need not
// be sorted within itself; negative ids sort before every cell), then the
// block walks those rows once and marks in shared memory where each cell of
// the tile starts. The tile's rows are one contiguous run of vals: the
// block stages it through shared memory a piece at a time (every thread's
// loads of a piece in flight at once), and owner threads fold each row
// into their cell's running max (channels [0, num_max)) or f64 sum
// (channels [num_max, C)) in row order, from shared memory, carrying a
// cell that goes on into the next piece. A long cell (a near-range pillar
// holds over 200 points) thus costs shared-memory reads, not a chain of
// device-memory round trips. Each owner writes its cell once, empty cells
// included (-3e38 or 0): 4 channels of one cell a thread, stored as one
// 16-byte vector, where the part's width allows it (a warp stores 512
// contiguous bytes); one channel a thread otherwise (the 1-channel count
// part of `split`: one coalesced float a cell). A thread's cells and
// channels follow from the tile and its index: no division per element.
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
constexpr int kMaxTile = 1024;     // cells per block
constexpr float kEmptyMax = -3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

// The first row of ids[0, n) whose id, clamped to ncells, is >= v (n if
// none); run by one whole warp.
__device__ int lower_bound_warp(const int* __restrict__ ids, int n,
                                int ncells, int v, int lane) {
  int lo = 0, hi = n;   // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = min(lo + lane * step + step - 1, hi - 1);
    const unsigned hit = __ballot_sync(kFull, min(ids[p], ncells) >= v);
    if (hit == 0) return hi;
    const int k = __ffs(hit) - 1;
    hi = min(lo + k * step + step - 1, hi - 1);
    if (k > 0) lo += k * step;
  }
  const unsigned hit = __ballot_sync(
      kFull, lo + lane < hi && min(ids[lo + lane], ncells) >= v);
  return hit ? lo + __ffs(hit) - 1 : hi;
}

constexpr int kStage = 8192;      // floats of staged rows
constexpr int kLoads = 16;        // staging loads in flight a thread
constexpr int kMark = 8;          // ids in flight a thread, marking

__shared__ float stage[kStage];   // a piece of the tile's rows

// One thread's walk over its cells of one part of the table: cells j0,
// j0 + per, ... of the tile (in row order), channels [ch, ch + VEC) of
// each, with the running max and sum of the cell in progress.
template <int VEC>
struct Cursor {
  int j, per, off, ch, ncell, width;
  float* dst;      // the part's row of the tile's first cell
  float mx[VEC];
  double sm[VEC];

  // per == 0: the part is too wide for one pass of owners, or a row too
  // wide for the stage (see wide()).
  __device__ void begin(int tid, int ch0, int width_, int ncell_, int c,
                        float* dst_) {
    const int gw = width_ / VEC;          // owner threads a cell
    per = gw > 0 && gw <= kThreads && c <= kStage ? kThreads / gw : 0;
    const bool owns = per > 0 && tid / gw < per;
    j = owns ? tid / gw : ncell_;         // no cell: done at once
    off = owns ? (tid % gw) * VEC : 0;
    ch = ch0 + off;
    ncell = ncell_;
    width = width_;
    dst = dst_;
    reset();
  }
  __device__ void reset() {
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      mx[q] = kEmptyMax;
      sm[q] = 0.0;
    }
  }
  // Fold the staged rows [p0, p1) (row r at stage[(r - p0) * c]); write
  // every cell that ends by p1.
  __device__ void advance(const int* cstart, int p0, int p1, int c,
                          int num_max) {
    while (j < ncell) {
      const int stop = cstart[j + 1];
      const int to = min(stop, p1);
      int i = max(cstart[j], p0);
      int at = (i - p0) * c + ch;
#pragma unroll 4
      for (; i < to; ++i, at += c) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          const float x = stage[at + q];
          if (ch + q < num_max)
            mx[q] = fmaxf(mx[q], x);
          else
            sm[q] += (double)x;
        }
      }
      if (stop > p1) return;              // the cell goes on
      float res[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        res[q] = ch + q < num_max ? mx[q] : (float)sm[q];
      float* d = dst + (size_t)j * width + off;
      if constexpr (VEC == 4)
        *reinterpret_cast<float4*>(d) =
            make_float4(res[0], res[1], res[2], res[3]);
      else
        *d = res[0];
      reset();
      j += per;
    }
  }
};

// A part wider than kThreads owners, or a table whose rows are wider than
// the stage: every cell walked from device memory, one channel a thread.
__device__ void wide(const float* __restrict__ vals,
                     const int* __restrict__ cstart, int ncell, int c,
                     int num_max, int ch0, int width, float* __restrict__ dst) {
  for (int j = 0; j < ncell; ++j) {
    const int start = cstart[j], stop = cstart[j + 1];
    for (int q = threadIdx.x; q < width; q += kThreads) {
      const int ch = ch0 + q;
      const float* v = vals + (size_t)start * c + ch;
      float mx = kEmptyMax;
      double sm = 0.0;
      for (int i = start; i < stop; ++i, v += c) {
        if (ch < num_max)
          mx = fmaxf(mx, *v);
        else
          sm += (double)*v;
      }
      dst[(size_t)j * width + q] = ch < num_max ? mx : (float)sm;
    }
  }
}

// HV, TV: channels a thread in the head part (out) and the tail part
// (out_tail): 4 needs the part's width % 4 == 0 and its pointer 16-byte
// aligned. A part wider than 4 * kThreads (or kThreads) channels, and a
// table whose rows are wider than the stage, take wide() instead.
template <int HV, int TV>
__global__ void __launch_bounds__(kThreads)
segment_paint_kernel(const float* __restrict__ vals,  // (B, N, C) by cell
                     const int* __restrict__ ids,     // (B, N) ascending
                     float* __restrict__ out,         // (B, ncells, split)
                     float* __restrict__ out_tail,    // (B, ncells, C - split)
                     int nb, int n, int ncells, int c, int num_max,
                     int split, int tile_cells) {
  __shared__ int range[2];
  __shared__ int cstart[kMaxTile + 1];
  // Grid: (tile, cloud % 65535, cloud / 65535).
  const int b = (int)(blockIdx.z * 65535u + blockIdx.y);
  if (b >= nb) return;
  const int c0 = (int)blockIdx.x * tile_cells;
  const int ncell = min(tile_cells, ncells - c0);
  const int* ib = ids + (size_t)b * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (warp < 2) {
    const int r = lower_bound_warp(ib, n, ncells, c0 + warp * ncell, lane);
    if (lane == 0) range[warp] = r;
  }
  __syncthreads();
  const int lo = range[0], hi = range[1];
  // Row i starts the cells (id[i - 1], id[i]]; rows lo and hi stand for the
  // tile's edges. Every cstart[0..ncell] is written once.
  // kMark rows a thread, their loads in flight together.
  for (int i0 = lo + tid; i0 <= hi; i0 += kMark * kThreads) {
    int prev[kMark], cur[kMark];
#pragma unroll
    for (int u = 0; u < kMark; ++u) {
      const int i = i0 + u * kThreads;
      prev[u] = i > hi ? 0 : i == lo ? c0 - 1 : min(ib[i - 1], ncells);
      cur[u] = i >= hi ? c0 + ncell : min(ib[i], ncells);
    }
#pragma unroll
    for (int u = 0; u < kMark; ++u)
      if (i0 + u * kThreads <= hi)
        for (int cell = prev[u] + 1; cell <= cur[u]; ++cell)
          cstart[cell - c0] = i0 + u * kThreads;
  }
  __syncthreads();

  Cursor<HV> head;
  Cursor<TV> tail;
  head.begin(tid, 0, split, ncell, c,
             out + ((size_t)b * ncells + c0) * split);
  tail.begin(tid, split, c - split, split < c ? ncell : 0, c,
             out_tail + ((size_t)b * ncells + c0) * (c - split));
  const float* vb = vals + (size_t)b * n * c;
  const int piece = kStage / c;           // rows a piece
  for (int p0 = lo; c <= kStage; p0 += piece) {
    const int p1 = min(p0 + piece, hi);
    const float* from = vb + (size_t)p0 * c;
    const int count = (p1 - p0) * c;
    for (int e0 = tid; e0 < count; e0 += kLoads * kThreads) {
      float x[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        x[u] = e0 + u * kThreads < count ? from[e0 + u * kThreads] : 0.f;
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (e0 + u * kThreads < count) stage[e0 + u * kThreads] = x[u];
    }
    __syncthreads();
    head.advance(cstart, p0, p1, c, num_max);
    tail.advance(cstart, p0, p1, c, num_max);
    if (p1 >= hi) break;
    __syncthreads();                      // before the next piece lands
  }
  if (head.per == 0)
    wide(vb, cstart, ncell, c, num_max, 0, split,
         out + ((size_t)b * ncells + c0) * split);
  if (split < c && tail.per == 0)
    wide(vb, cstart, ncell, c, num_max, split, c - split,
         out_tail + ((size_t)b * ncells + c0) * (c - split));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int multiprocessors() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

template <int HV, int TV>
int launch(const void* vals, const void* ids, void* out, void* out_tail,
           int b, int n, int ncells, int c, int num_max, int split,
           cudaStream_t stream) {
  // About 32 owner threads' work a thread (fewer cells for wide tables),
  // halved while the grid would leave multiprocessors idle.
  const int threads_a_cell = split / HV + (c - split) / TV;
  int tile_cells = kMaxTile;
  while (tile_cells > 32 && tile_cells * threads_a_cell > 32 * kThreads)
    tile_cells /= 2;
  while (tile_cells > 32 &&
         (long long)b * ((ncells + tile_cells - 1) / tile_cells) <
             2LL * multiprocessors())
    tile_cells /= 2;
  const int tiles = (ncells + tile_cells - 1) / tile_cells;
  const dim3 grid((unsigned)tiles, (unsigned)(b < 65535 ? b : 65535),
                  (unsigned)((b + 65534) / 65535));
  segment_paint_kernel<HV, TV><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(vals), static_cast<const int*>(ids),
      static_cast<float*>(out), static_cast<float*>(out_tail), b, n, ncells,
      c, num_max, split, tile_cells);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns the cudaError_t of the
// launch; 0 means it was accepted.
extern "C" int lisec_segment_paint(const void* vals, const void* ids,
                                   void* out, void* out_tail, int b, int n,
                                   int ncells, int c, int num_max, int split,
                                   void* stream) {
  if (b < 1 || n < 0 || ncells < 1 || c < 1 || num_max < 0 || num_max > c ||
      split < 1 || split > c || (split < c && out_tail == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((unsigned long long)ncells * c >= 2147483648ull)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool hv = split % 4 == 0 && aligned16(out);
  const bool tv = split < c && (c - split) % 4 == 0 && aligned16(out_tail);
  if (hv && tv)
    return launch<4, 4>(vals, ids, out, out_tail, b, n, ncells, c, num_max,
                        split, s);
  if (hv)
    return launch<4, 1>(vals, ids, out, out_tail, b, n, ncells, c, num_max,
                        split, s);
  if (tv)
    return launch<1, 4>(vals, ids, out, out_tail, b, n, ncells, c, num_max,
                        split, s);
  return launch<1, 1>(vals, ids, out, out_tail, b, n, ncells, c, num_max,
                      split, s);
}
