// Fused pillar encoder for Hopper: raw padded points -> BEV canvas.
//
// Replaces lisec_tpu/ops/pallas/encoder_kernel.py::pillar_canvas_fused
// (body _encoder_kernel). The wrapper, its bound and the design notes are
// in lisec_tpu_torch/ops/cuda/encoder_kernel.py.
//
// Two launches, no torch glue around them:
//
// 1. cells_kernel: one thread a point computes its cell id with the f32
//    arithmetic of the wrapper's pillar_cells (a multiply by the f32
//    reciprocal of the voxel size, floor, clamp to [-1, n] before the int
//    cast, the z range, the mask; nx * ny where the point is invalid) and
//    writes the ids, (B, N4) int32 with N4 = N rounded up to a multiple of
//    4 (rows 16-byte aligned). Each block of kChunk points also writes
//    how many of its points land in each tile of kTile cells, (B, nchunks,
//    ntiles) in full, so nothing has to be zeroed beforehand.
//
// 2. canvas_kernel: one block owns a tile of kTile consecutive cells of one
//    cloud. From the counts it learns how many points land in its tile and
//    which chunks hold any. Its warps stream those chunks' ids (from L2,
//    eight 16-byte loads a lane in flight) and gather a key (cell in the
//    tile << 20 | point index) for every point that lands, counting the
//    points of each cell. The keys are then put in order, by cell and
//    within a cell by point index: each into its cell's bucket (the
//    prefix of the counts), then to the place its rank among the bucket's
//    keys gives it, so that no sort with a barrier a step is needed. The
//    empty rows of the tile are written as zeros with 16-byte stores. Each
//    warp looks at 32 places of the ordered keys at a time, every lane
//    loading the point of its place, and walks each cell that starts
//    there in point order (shuffles), lane l owning the CPL contiguous
//    channels [l * CPL, (l + 1) * CPL): the running max of u = [x, y, z,
//    r] @ weff and the f64 xyz sums in registers, then the epilogue, and
//    one coalesced row. Every element of the canvas is written once; the
//    keys fix the order of every sum, so a run repeats bit for bit.
//
//    A tile whose points exceed the kCap keys shared memory holds stays
//    exact: the block takes the tile in runs of cells of at most kCap
//    points, each with its own stream of the ids; a cell that alone holds
//    more than kCap points is walked by one warp straight from the ids, in
//    point order, with its state in registers.
//
// The arithmetic uses the _rn intrinsics so that nvcc cannot contract it
// into FMAs: the plain PyTorch version performs the same f32 operations in
// the same order, so the two agree bit for bit up to the order of the f64
// xyz sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;           // points a cells block
constexpr int kTile = 2048;            // cells a canvas block
constexpr int kCap = 4096;             // keys ordered in shared memory at once
constexpr int kMaxTiles = 4096;        // tiles a cloud (cells_kernel's table)
constexpr int kIdxBits = 20;           // point index bits of a key
constexpr unsigned kIdxMask = (1u << kIdxBits) - 1u;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kTile << kIdxBits <= 0x7fffffff, "keys must fit 31 bits");

template <typename T>
__device__ __forceinline__ T to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__global__ void __launch_bounds__(kThreads)
cells_kernel(const float4* __restrict__ pts,          // (B, N) x, y, z, r
             const unsigned char* __restrict__ mask,  // (B, N) bool
             int* __restrict__ ids,                   // (B, N4)
             int* __restrict__ counts,                // (B, nchunks, ntiles)
             int n, int n4, int nchunks, int ntiles, int nx, int ny, float r0,
             float r1, float z0, float z1, float inv0, float inv1) {
  __shared__ int hist[kMaxTiles];
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < ntiles; i += kThreads) hist[i] = 0;
  __syncthreads();
  const int ncells = nx * ny;
#pragma unroll
  for (int k = 0; k < kChunk / kThreads; ++k) {
    const int i = chunk * kChunk + k * kThreads + tid;
    int tile = -1;
    if (i < n) {
      const size_t at = (size_t)b * n + i;
      const float4 p = pts[at];
      // pillar_cells: floor((x - r0) * inv0), clamped to [-1, nx].
      const float fx = fminf(
          fmaxf(floorf(__fmul_rn(__fsub_rn(p.x, r0), inv0)), -1.0f),
          (float)nx);
      const float fy = fminf(
          fmaxf(floorf(__fmul_rn(__fsub_rn(p.y, r1), inv1)), -1.0f),
          (float)ny);
      const int ix = (int)fx, iy = (int)fy;
      const bool ok = mask[at] != 0 && ix >= 0 && ix < nx && iy >= 0 &&
                      iy < ny && p.z >= z0 && p.z < z1;
      const int cell = ok ? iy * nx + ix : ncells;
      ids[(size_t)b * n4 + i] = cell;
      if (ok) tile = cell / kTile;
    }
    // One shared add a tile a warp.
    const unsigned peers = __match_any_sync(kFull, tile);
    if (tile >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&hist[tile], __popc(peers));
  }
  __syncthreads();
  int* out = counts + ((size_t)b * nchunks + chunk) * ntiles;
  for (int i = tid; i < ntiles; i += kThreads) out[i] = hist[i];
}

// The per-channel weights of a lane's CPL channels, in registers.
template <int CPL>
struct Weights {
  float we0[CPL], we1[CPL], we2[CPL], we3[CPL];   // weff = folded w[0:4]
  float w4[CPL], w5[CPL], w6[CPL], w7[CPL], w8[CPL], t[CPL];

  __device__ void load(const float* __restrict__ w,
                       const float* __restrict__ tt, int c0, int C) {
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = c0 + k;
      // weff folds the absolute-decoration columns of the 9-channel PFN
      // input [x, y, z, r, x, y, z, x, y]: u = [x, y, z, r] @ weff.
      we0[k] = __fadd_rn(__fadd_rn(w[c], w[4 * C + c]), w[7 * C + c]);
      we1[k] = __fadd_rn(__fadd_rn(w[C + c], w[5 * C + c]), w[8 * C + c]);
      we2[k] = __fadd_rn(w[2 * C + c], w[6 * C + c]);
      we3[k] = w[3 * C + c];
      w4[k] = w[4 * C + c];
      w5[k] = w[5 * C + c];
      w6[k] = w[6 * C + c];
      w7[k] = w[7 * C + c];
      w8[k] = w[8 * C + c];
      t[k] = tt[c];
    }
  }
};

// One cell's running state on one lane: the max of u over its channels
// and the (redundant) f64 xyz sums, added in point order.
template <int CPL>
struct Cell {
  float umax[CPL];
  double sx, sy, sz;
  int count;

  __device__ void reset() {
#pragma unroll
    for (int k = 0; k < CPL; ++k) umax[k] = -INFINITY;
    sx = sy = sz = 0.0;
    count = 0;
  }
  // Add the point that lane q holds in p.
  __device__ void add(const Weights<CPL>& W, float4 p, int q) {
    const float x = __shfl_sync(kFull, p.x, q);
    const float y = __shfl_sync(kFull, p.y, q);
    const float z = __shfl_sync(kFull, p.z, q);
    const float r = __shfl_sync(kFull, p.w, q);
    sx += x;
    sy += y;
    sz += z;
    ++count;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const float u = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(x, W.we0[k]), __fmul_rn(y, W.we1[k])),
                    __fmul_rn(z, W.we2[k])),
          __fmul_rn(r, W.we3[k]));
      umax[k] = fmaxf(umax[k], u);
    }
  }
  // Add the points that lanes from .. from + m - 1 hold, in lane order;
  // eight at a time where it can, so that their shuffles overlap.
  __device__ void add_lanes(const Weights<CPL>& W, float4 p, int from,
                            int m) {
    int q = from;
    for (; q + 8 <= from + m; q += 8) {
#pragma unroll
      for (int k = 0; k < 8; ++k) add(W, p, q + k);
    }
    for (; q < from + m; ++q) add(W, p, q);
  }
  // Epilogue relu(max u - mean @ w[4:7] - center @ w[7:9] + t), stored as
  // the lane's CPL contiguous channels of the cell's row.
  template <typename OutT>
  __device__ void store(const Weights<CPL>& W, OutT* row, int cell, int nx,
                        float vs0, float vs1, float r0, float r1) const {
    const float cnt = (float)count;
    const float mx = __fdiv_rn((float)sx, cnt);
    const float my = __fdiv_rn((float)sy, cnt);
    const float mz = __fdiv_rn((float)sz, cnt);
    const float cx = __fadd_rn(
        __fmul_rn(__fadd_rn((float)(cell % nx), 0.5f), vs0), r0);
    const float cy = __fadd_rn(
        __fmul_rn(__fadd_rn((float)(cell / nx), 0.5f), vs1), r1);
    float res[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const float b_mean = __fadd_rn(
          __fadd_rn(__fmul_rn(mx, W.w4[k]), __fmul_rn(my, W.w5[k])),
          __fmul_rn(mz, W.w6[k]));
      const float b_ctr =
          __fadd_rn(__fmul_rn(cx, W.w7[k]), __fmul_rn(cy, W.w8[k]));
      res[k] = fmaxf(
          __fadd_rn(__fsub_rn(__fsub_rn(umax[k], b_mean), b_ctr), W.t[k]),
          0.0f);
    }
    constexpr int kBytes = CPL * (int)sizeof(OutT);
    if constexpr (kBytes % 4 != 0) {
#pragma unroll
      for (int k = 0; k < CPL; ++k) row[k] = to_out<OutT>(res[k]);
    } else {
      // The lane's channels as 32-bit words, stored 16, 8 or 4 bytes at a
      // time.
      constexpr int kWords = kBytes / 4;
      unsigned wd[kWords];
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        if constexpr (sizeof(OutT) == 4)
          wd[q] = __float_as_uint(res[q]);
        else
          wd[q] = (unsigned)__bfloat16_as_ushort(to_out<OutT>(res[2 * q])) |
                  ((unsigned)__bfloat16_as_ushort(
                       to_out<OutT>(res[2 * q + 1]))
                   << 16);
      }
      if constexpr (kWords % 4 == 0) {
#pragma unroll
        for (int q = 0; q < kWords; q += 4)
          reinterpret_cast<uint4*>(row)[q / 4] =
              make_uint4(wd[q], wd[q + 1], wd[q + 2], wd[q + 3]);
      } else if constexpr (kWords % 2 == 0) {
#pragma unroll
        for (int q = 0; q < kWords; q += 2)
          reinterpret_cast<uint2*>(row)[q / 2] = make_uint2(wd[q], wd[q + 1]);
      } else {
#pragma unroll
        for (int q = 0; q < kWords; ++q)
          reinterpret_cast<unsigned*>(row)[q] = wd[q];
      }
    }
  }
};

// Sum of x over the block; every thread gets it. Uses red[kWarps].
__device__ int block_sum(int x, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = __reduce_add_sync(kFull, x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  return __reduce_add_sync(kFull, lane < kWarps ? red[lane] : 0);
}

// Dynamic shared memory of canvas_kernel: two key arrays, and a cell's
// count, first key and placement cursor.
constexpr size_t kSmemBytes =
    (size_t)2 * kCap * sizeof(unsigned) +
    (size_t)(3 * kTile + 1) * sizeof(int);

template <int CPL, typename OutT>
__global__ void __launch_bounds__(kThreads)
canvas_kernel(const float4* __restrict__ pts,    // (B, N) x, y, z, r
              const int* __restrict__ ids,       // (B, N4) cell ids
              const int* __restrict__ counts,    // (B, nchunks, ntiles)
              const float* __restrict__ w,       // (9, C) BN-folded
              const float* __restrict__ t,       // (C,)
              OutT* __restrict__ out,            // (B, ncells, C)
              int n, int n4, int nchunks, int ntiles, int ncells, int nx,
              float vs0, float vs1, float r0, float r1) {
  constexpr int C = CPL * 32;
  constexpr int kUnits = C * (int)sizeof(OutT) / 16;   // 16-byte units a row
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* keys = reinterpret_cast<unsigned*>(smem);  // [kCap] gathered,
                                                       // then in order
  unsigned* bucket = keys + kCap;                      // [kCap] by cell
  int* cnt = reinterpret_cast<int*>(bucket + kCap);    // [kTile] points
  int* first = cnt + kTile;                            // [kTile + 1] prefix
  int* cur = first + kTile + 1;                        // [kTile] cursors
  __shared__ int red[kWarps];
  __shared__ int nkeys;

  const int tile = blockIdx.x, b = blockIdx.y;
  const int c0 = tile * kTile;
  const int ncell = min(kTile, ncells - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int* ib = ids + (size_t)b * n4;
  const float4* pb = pts + (size_t)b * n;
  const int* cb = counts + (size_t)b * nchunks * ntiles + tile;
  OutT* orow = out + ((size_t)b * ncells + c0) * C + lane * CPL;

  Weights<CPL> W;
  W.load(w, t, lane * CPL, C);

  int p = 0;
  for (int ch = tid; ch < nchunks; ch += kThreads)
    p += cb[(size_t)ch * ntiles];
  const int total = block_sum(p, red);
  for (int j = tid; j < kTile; j += kThreads) cnt[j] = cur[j] = 0;
  if (tid == 0) nkeys = 0;
  __syncthreads();

  // Stream the ids of every chunk that holds a point of the tile (warp w
  // takes chunks w, w + kWarps, ...; a lane's eight 16-byte loads of a
  // chunk in flight together): with collect, gather the keys of the
  // points in cells [lo, hi) of the tile into keys, in any order; with
  // count_cells, count the points of each cell into cnt.
  auto stream = [&](bool collect, bool count_cells, int lo, int hi) {
    for (int ch = warp; ch < nchunks; ch += kWarps) {
      if (cb[(size_t)ch * ntiles] == 0) continue;
      const int start = ch * kChunk, stop = min(n, start + kChunk);
      const int4* cp = reinterpret_cast<const int4*>(ib + start);
      int4 v[kChunk / 128];
#pragma unroll
      for (int q = 0; q < kChunk / 128; ++q)
        v[q] = start + (lane + 32 * q) * 4 < stop ? cp[lane + 32 * q]
                                                  : make_int4(-1, -1, -1, -1);
#pragma unroll
      for (int q = 0; q < kChunk / 128; ++q) {
        const int i0 = start + (lane + 32 * q) * 4;   // the lane's first id
        int local[4] = {v[q].x - c0, v[q].y - c0, v[q].z - c0, v[q].w - c0};
        unsigned bal[4];
        int land = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool in = i0 + k < stop && local[k] >= lo && local[k] < hi;
          bal[k] = __ballot_sync(kFull, in);
          land += __popc(bal[k]);
          if (!in) local[k] = -1;
        }
        if (land == 0) continue;
        if (count_cells) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const unsigned peers = __match_any_sync(kFull, local[k]);
            if (local[k] >= 0 && lane == __ffs(peers) - 1)
              atomicAdd(&cnt[local[k]], __popc(peers));
          }
        }
        if (collect) {
          int base = 0;
          if (lane == 0) base = atomicAdd(&nkeys, land);
          base = __shfl_sync(kFull, base, 0);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (local[k] >= 0)
              keys[base + __popc(bal[k] & below)] =
                  ((unsigned)local[k] << kIdxBits) | (unsigned)(i0 + k);
            base += __popc(bal[k]);
          }
        }
      }
    }
  };

  // Put the nk gathered keys of cells [lo, hi) in order, cell by cell and
  // within a cell by point index: each goes into its cell's bucket (at
  // first[cell] - first[lo], in any order), then to the place its rank
  // among the bucket's keys gives it.
  auto order = [&](int lo, int nk) {
    const int base = first[lo];
    for (int e = tid; e < nk; e += kThreads) {
      const unsigned key = keys[e];
      const int cell = (int)(key >> kIdxBits);
      bucket[first[cell] - base + atomicAdd(&cur[cell], 1)] = key;
    }
    __syncthreads();
    for (int e = tid; e < nk; e += kThreads) {
      const unsigned key = bucket[e];
      const int cell = (int)(key >> kIdxBits);
      const int s = first[cell] - base, stop = s + cnt[cell];
      int rank = 0;
      for (int k = s; k < stop; ++k) rank += bucket[k] < key;
      keys[s + rank] = key;
    }
    __syncthreads();
  };

  // The cells whose keys start in keys[0, nk): warp w looks at places w *
  // 32 + 256 q (each lane loading the point of its place, all in one
  // round trip), and walks each cell that starts there, its points in
  // point order.
  auto compute = [&](int nk) {
    Cell<CPL> acc;
    const float4 none = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e0 = warp * 32; e0 < nk; e0 += kThreads) {
      const int e = e0 + lane;
      const unsigned key = e < nk ? keys[e] : kFull;
      const unsigned cell = key >> kIdxBits;
      const bool starts =
          e < nk && (e == 0 || (keys[e - 1] >> kIdxBits) != cell);
      const float4 mine = e < nk ? pb[key & kIdxMask] : none;
      unsigned heads = __ballot_sync(kFull, starts);
      while (heads) {
        const int h = __ffs(heads) - 1;
        heads &= heads - 1;
        const int j = (int)__shfl_sync(kFull, cell, h);
        const int stop = e0 + h + cnt[j];
        acc.reset();
        acc.add_lanes(W, mine, h, min(stop, e0 + 32) - (e0 + h));
        for (int base = e0 + 32; base < stop; base += 32) {
          const int i = base + lane;
          const float4 q = i < stop ? pb[keys[i] & kIdxMask] : none;
          acc.add_lanes(W, q, 0, min(32, stop - base));
        }
        acc.store(W, orow + (size_t)j * C, c0 + j, nx, vs0, vs1, r0, r1);
      }
    }
  };

  const bool fits = total <= kCap;
  // With fits, gather every key and count; else count only.
  stream(fits, true, 0, ncell);
  __syncthreads();

  // first = exclusive prefix of cnt over the tile.
  {
    constexpr int kPer = kTile / kThreads;           // 8 cells a thread
    int v[kPer], sum = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      v[k] = sum;
      sum += cnt[tid * kPer + k];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int x = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += x;
    }
    if (lane == 31) red[warp] = incl;
    __syncthreads();
    int prev = 0;
    for (int k = 0; k < warp; ++k) prev += red[k];
    const int off = prev + incl - sum;
#pragma unroll
    for (int k = 0; k < kPer; ++k) first[tid * kPer + k] = off + v[k];
    if (tid == kThreads - 1) first[kTile] = off + sum;
  }
  __syncthreads();

  // Zero rows for the empty cells, 16 bytes a store.
  {
    uint4* ob = reinterpret_cast<uint4*>(out + ((size_t)b * ncells + c0) * C);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int e = tid; e < ncell * kUnits; e += kThreads)
      if (cnt[e / kUnits] == 0) ob[e] = zero;
  }

  if (fits) {
    order(0, total);
    compute(total);
    return;
  }

  // More points than kCap keys: take the tile in runs of cells that fit.
  int a = 0;
  while (a < ncell) {
    // The longest run of cells from a whose points fit kCap keys.
    int lo = a, hi = ncell;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (first[mid] - first[a] <= kCap) lo = mid; else hi = mid - 1;
    }
    hi = lo;
    if (hi == a) {
      // Cell a alone holds more than kCap points: warp 0 walks the chunks'
      // ids in point order, its state in registers.
      if (warp == 0) {
        Cell<CPL> acc;
        acc.reset();
        for (int ch = 0; ch < nchunks; ++ch) {
          if (cb[(size_t)ch * ntiles] == 0) continue;
          const int start = ch * kChunk, stop = min(n, start + kChunk);
          for (int i0 = start; i0 < stop; i0 += 32) {
            const int i = i0 + lane;
            const bool in = i < stop && ib[i] - c0 == a;
            unsigned bal = __ballot_sync(kFull, in);
            if (bal == 0) continue;
            const float4 q = in ? pb[i] : make_float4(0.f, 0.f, 0.f, 0.f);
            while (bal) {
              acc.add(W, q, __ffs(bal) - 1);
              bal &= bal - 1;
            }
          }
        }
        acc.store(W, orow + (size_t)a * C, c0 + a, nx, vs0, vs1, r0, r1);
      }
      a += 1;
      continue;
    }
    __syncthreads();              // the last run's keys are read
    if (tid == 0) nkeys = 0;
    __syncthreads();
    stream(true, false, a, hi);
    __syncthreads();
    order(a, first[hi] - first[a]);
    compute(first[hi] - first[a]);
    a = hi;
  }
}

template <int CPL, typename OutT>
cudaError_t launch(const void* pts, const void* mask, const void* w,
                   const void* t, void* out, int* ids, int* counts, int b,
                   int n, int nx, int ny, float vs0, float vs1, float r0,
                   float r1, float z0, float z1, float inv0, float inv1,
                   cudaStream_t s) {
  const int ncells = nx * ny;
  const int n4 = (n + 3) / 4 * 4;
  const int nchunks = (n + kChunk - 1) / kChunk;
  const int ntiles = (ncells + kTile - 1) / kTile;
  cells_kernel<<<dim3(nchunks, b), kThreads, 0, s>>>(
      static_cast<const float4*>(pts),
      static_cast<const unsigned char*>(mask), ids, counts, n, n4, nchunks,
      ntiles, nx, ny, r0, r1, z0, z1, inv0, inv1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  static bool smem_set = false;   // once a kernel instance
  if (!smem_set) {
    e = cudaFuncSetAttribute(canvas_kernel<CPL, OutT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  canvas_kernel<CPL, OutT><<<dim3(ntiles, b), kThreads, kSmemBytes, s>>>(
      static_cast<const float4*>(pts), ids, counts,
      static_cast<const float*>(w), static_cast<const float*>(t),
      static_cast<OutT*>(out), n, n4, nchunks, ntiles, ncells, nx, vs0, vs1,
      r0, r1);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch(int c, const void* pts, const void* mask,
                     const void* w, const void* t, void* out, int* ids,
                     int* counts, int b, int n, int nx, int ny, float vs0,
                     float vs1, float r0, float r1, float z0, float z1,
                     float inv0, float inv1, cudaStream_t s) {
#define LISEC_CASE(CPL)                                                   \
  case CPL:                                                               \
    return launch<CPL, OutT>(pts, mask, w, t, out, ids, counts, b, n, nx, \
                             ny, vs0, vs1, r0, r1, z0, z1, inv0, inv1, s);
  switch (c / 32) {
    LISEC_CASE(1)
    LISEC_CASE(2)
    LISEC_CASE(3)
    LISEC_CASE(4)
    LISEC_CASE(5)
    LISEC_CASE(6)
    LISEC_CASE(7)
    LISEC_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef LISEC_CASE
}

}  // namespace

// Plain C entry point (loaded with ctypes): pts (B, N, 4) f32, 16-byte
// aligned; mask (B, N) bool; w (9, C), t (C,) f32; out (B, nx * ny, C) f32
// or bf16, 16-byte aligned; scratch of B * N4 + B * nchunks * ntiles int32
// (N4 = N rounded up to a multiple of 4, nchunks = ceil(N / kChunk),
// ntiles = ceil(nx * ny / kTile)), 16-byte aligned.
// Two launches. Returns the cudaError_t of the launches; 0 means both were
// accepted.
extern "C" int lisec_pillar_canvas_fused(
    const void* pts, const void* mask, const void* w, const void* t,
    void* out, void* scratch, int b, int n, int c, int nx, int ny,
    float vs0, float vs1, float r0, float r1, float z0, float z1,
    float inv0, float inv1, int out_bf16, void* stream) {
  if (c % 32 != 0 || c < 32 || c > 256 || b < 1 || b > 65535 || n < 1 ||
      n > (1 << kIdxBits) || nx < 1 || ny < 1 ||
      (long long)nx * ny > (long long)kMaxTiles * kTile ||
      reinterpret_cast<uintptr_t>(pts) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int* ids = static_cast<int*>(scratch);
  int* counts = ids + (size_t)b * ((n + 3) / 4 * 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return (int)dispatch<__nv_bfloat16>(c, pts, mask, w, t, out, ids, counts,
                                        b, n, nx, ny, vs0, vs1, r0, r1, z0,
                                        z1, inv0, inv1, s);
  return (int)dispatch<float>(c, pts, mask, w, t, out, ids, counts, b, n, nx,
                              ny, vs0, vs1, r0, r1, z0, z1, inv0, inv1, s);
}
