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
// It copies bits, so it is exact in both types, and writes every output
// element once, the zero rows of out-of-range ids included. Bound by
// bytes: the ids, the rows they name and the output (the feature gathers
// of a PointNet++ predict at batch 16 hold almost all of it). A row is a
// run of units V (16 bytes where the row's length and the pointers allow,
// else 8, 4 or 2) and is moved by a group of L lanes, L a power of two up
// to 32: lane j moves units j, j + L, ... Rows of at most four units (C =
// 3 in f32: one 12-byte row) are moved whole by one thread (L = 1). The
// group's first lane loads the row's id once, finds the source row (the
// cloud from a 32-bit division) and hands it to the other lanes by a
// shuffle. A lane group keeps two rows in flight, a thread that moves a
// narrow row all its units (every load issued before the stores).
// Offsets are 32-bit: the wrapper refuses a src or an output of 2^31
// elements or more.
//
// Grouping (PointNet++'s group_and_decorate), xyz (B, N, 3) f32, features
// (B, N, C) f32 or none, centres (B, M, 3) f32, idx (B, M * K) int32:
//
//   out[b, r, 0:3] = xyz[b, idx[b, r]] - centres[b, r / K]    (f32)
//   out[b, r, 3:]  = features[b, idx[b, r]]                   (a copy)
//
// in one launch, straight into the (B, M * K, 3 + C) output that the
// shared MLP reads, with out-of-range ids taken as zero rows, as the
// gather does. Without features one thread moves a row (its three
// coordinates and its centre's); with them a group of L lanes (4 to 32)
// moves the feature channels and its first three lanes the coordinates.
// The output rows (3 + C floats) are 4-byte aligned only, so every unit
// is one float; a warp's stores are contiguous all the same. It replaces
// two gathers, a subtraction and a concatenation, which read and wrote
// the grouped tensor again (69 MB each way in SA2 at batch 16).

// Scatter, vals (B, M, C) f32, idx (B, M) int32:
//
//   out[b, r, :] = sum of vals[b, m, :] over m with idx[b, m] = r, in m order
//
// One launch, no glue. A block owns a tile of target rows of one cloud (and
// up to 32 channel groups of them). It streams the cloud's ids in chunks of
// 2048, in m order (the next chunk's ids load while it works on this one),
// and sorts the chunk's ids that land in its tile by target with a stable
// counting sort in shared memory: each warp counts its 256 ids per target
// (__match_any_sync gives a lane its rank among equal ids of its round), a
// scan over (target, warp) gives every id its place, and the ids are
// placed. The block then asks L2 for every landed row, and owner threads,
// one per (target row, 4 channels) and slot, add the chunk's rows of their
// target in that order, eight row loads in flight, keeping the sums in
// registers across chunks; each writes its sums once at the end, zero rows
// included. So the additions are those of the plain version in its order
// (f32, m ascending): no atomics, a run repeats bit for bit, and duplicate
// ids (the ball query's repeat-fill makes them the normal case, up to 326
// on one target in a PointNet++ gradient) are summed in the order the TPU
// kernel's sequential grid adds them. A target's sum is one chain of
// dependent adds, so its rows cannot be split between threads; the L2
// request and the eight loads in flight shorten the waits in the chain.
// Ids outside [0, R) land in no tile and are dropped. Bound by bytes: the
// values of the rows that land, the ids and the table (154 MB for the
// three scatters of a PointNet++ train step at batch 16, 0.046 ms at 3.35
// TB/s). Each tile re-reads its cloud's ids, from L2 (at (16, 8192) ids
// onto 512 rows at most 32 MB), which the bound does not count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;                    // ids per lane per chunk
constexpr int kChunk = kThreads * kRounds;    // ids per chunk
constexpr int kMaxTile = 256;                 // target rows per block
constexpr int kMaxSlots = 4;                  // target rows per owner thread
constexpr int kBatch = 8;                     // row loads in flight
constexpr unsigned kFull = 0xffffffffu;

constexpr int kGatherThreads = 256;

// The source row of output row `row` (b * n + id, or -1 for an id
// outside [0, n)), loaded by the group's first lane and shared with the
// group's L lanes; every lane of the warp takes part.
__device__ __forceinline__ int source_row(const int* __restrict__ idx,
                                          int row, int rows, int n, int m,
                                          int j, int lanes) {
  int s = -1;
  if (j == 0 && row < rows) {
    const int id = __ldg(idx + row);
    if (id >= 0 && id < n) s = row / m * n + id;
  }
  return lanes > 1 ? __shfl_sync(kFull, s, 0, lanes) : s;
}

// V: the unit a lane moves (16, 8, 4 or 2 bytes). A block holds
// kGatherThreads >> lshift groups of 1 << lshift lanes and moves a tile
// of kRows * groups rows: group g moves rows tile * kRows * groups + r *
// groups + g, r < kRows, kUnits units of each row at a time.
template <typename V, int kRows, int kUnits>
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const V* __restrict__ src,   // (B, N, units)
              const int* __restrict__ idx,  // (B * M)
              V* __restrict__ out,          // (B * M, units)
              int n, int m, int rows, int units, int lshift) {
  const int lanes = 1 << lshift;
  const int groups = kGatherThreads >> lshift;
  const int j = threadIdx.x & (lanes - 1);
  const int first = blockIdx.x * kRows * groups + (threadIdx.x >> lshift);
  int from[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    from[r] = source_row(idx, first + r * groups, rows, n, m, j, lanes);
  for (int u0 = j; u0 < units; u0 += kUnits * lanes) {
    V v[kRows][kUnits];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int unit = u0 + u * lanes;
        v[r][u] = from[r] >= 0 && unit < units
                      ? __ldg(src + from[r] * units + unit)
                      : V{};
      }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = first + r * groups;
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int unit = u0 + u * lanes;
        if (row < rows && unit < units) out[row * units + unit] = v[r][u];
      }
    }
  }
}

// Grouping, in the same tiles. Without features (kFeatures false)
// lshift is 0 and a thread moves whole rows; with them the group's lanes
// move kUnits channels of each of kRows rows at a time, lanes 0-2 also
// the coordinates. A tile's loads (ids first, then coordinates, centres
// and the first channels) are all issued before its stores.
template <bool kFeatures, int kRows, int kUnits>
__global__ void __launch_bounds__(kGatherThreads)
group_kernel(const float* __restrict__ xyz,      // (B, N, 3)
             const float* __restrict__ feat,     // (B, N, C) or null
             const float* __restrict__ centres,  // (B, M, 3)
             const int* __restrict__ idx,        // (B * MK)
             float* __restrict__ out,            // (B * MK, 3 + C)
             int n, int mk, int k, int c, int rows, int lshift) {
  constexpr int kAxes = kFeatures ? 1 : 3;  // coordinates a lane moves
  const int lanes = 1 << lshift;
  const int groups = kGatherThreads >> lshift;
  const int j = threadIdx.x & (lanes - 1);
  const int w = 3 + c;
  const bool coords = !kFeatures || j < 3;
  const int step = kUnits * lanes;            // channels a pass
  const int passes = kFeatures ? (c + step - 1) / step : 0;
  const int first = blockIdx.x * kRows * groups + (threadIdx.x >> lshift);
  int from[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    from[r] = source_row(idx, first + r * groups, rows, n, mk, j, lanes);

  auto load_channels = [&](int u0, float (&v)[kRows][kUnits]) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int ch = u0 + u * lanes;
        v[r][u] = from[r] >= 0 && ch < c ? __ldg(feat + from[r] * c + ch)
                                         : 0.0f;
      }
  };
  auto store_channels = [&](int u0, const float (&v)[kRows][kUnits]) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = first + r * groups;
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int ch = u0 + u * lanes;
        if (row < rows && ch < c) out[row * w + 3 + ch] = v[r][u];
      }
    }
  };

  float p[kRows][kAxes], q[kRows][kAxes], v[kRows][kUnits];
  if (coords) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      // The centre's row: b * M + (the row within its cloud) / K.
      const int row = first + r * groups;
      const int b = row / mk;
      const int centre = b * (mk / k) + (row - b * mk) / k;
#pragma unroll
      for (int a = 0; a < kAxes; ++a) {
        const int axis = kFeatures ? j : a;
        p[r][a] = from[r] >= 0 ? __ldg(xyz + from[r] * 3 + axis) : 0.0f;
        q[r][a] = row < rows ? __ldg(centres + centre * 3 + axis) : 0.0f;
      }
    }
  }
  if (kFeatures && passes > 0) load_channels(j, v);
  if (coords) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = first + r * groups;
#pragma unroll
      for (int a = 0; a < kAxes; ++a)
        if (row < rows)
          out[row * w + (kFeatures ? j : a)] = __fsub_rn(p[r][a], q[r][a]);
    }
  }
  if (!kFeatures || passes == 0) return;
  store_channels(j, v);
  for (int pass = 1; pass < passes; ++pass) {
    load_channels(j + pass * step, v);
    store_channels(j + pass * step, v);
  }
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__device__ __forceinline__ void add_to(float& acc, float v) { acc += v; }
__device__ __forceinline__ void add_to(float4& acc, float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// V: float (one channel a group) or float4 (four). A block is (cloud, tile
// of tile_rows = per_pass * slots target rows, channel block of gb groups);
// thread t owns group t % gb of rows t / gb + s * per_pass, s < slots.
template <typename V>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const float* __restrict__ vals,  // (B, M, C)
               const int* __restrict__ idx,     // (B, M)
               float* __restrict__ out,         // (B, R, C)
               int nb, int m, int r, int c, int groups, int gb,
               int per_pass, int slots, int cblocks) {
  constexpr int kVec = sizeof(V) / sizeof(float);
  __shared__ int cnt[kWarps][kMaxTile];  // a warp's count, then its offset
  __shared__ int start[kMaxTile + 1];    // a target's first place
  __shared__ int wsum[kWarps];
  __shared__ int order[kChunk];          // chunk positions, by target

  // Grid: (tile * cblocks + channel block, cloud % 65535, cloud / 65535).
  const int b = (int)(blockIdx.z * 65535u + blockIdx.y);
  if (b >= nb) return;
  const int cb = (int)(blockIdx.x % (unsigned)cblocks);
  const int lo = (int)(blockIdx.x / (unsigned)cblocks) * per_pass * slots;
  const int nt = min(per_pass * slots, r - lo);   // target rows here

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int g = cb * gb + tid % gb;
  const int j = tid / gb;
  const bool owner = j < per_pass && g < groups;

  V acc[kMaxSlots];
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) acc[s] = V{};

  const int* ids = idx + (size_t)b * m;
  // This thread's ids of a chunk: lane + 32 k of its warp's 256.
  const int* mine = ids + warp * (kChunk / kWarps) + lane;
  int next[kRounds];
#pragma unroll
  for (int k = 0; k < kRounds; ++k)
    next[k] = warp * (kChunk / kWarps) + k * 32 + lane < m ? mine[k * 32]
                                                            : -1;

  for (int base = 0; base < m; base += kChunk) {
    for (int w = 0; w < kWarps; ++w)
      if (tid < nt) cnt[w][tid] = 0;

    // Each warp ranks its 256 ids (m order: round, then lane) per target;
    // the next chunk's ids load meanwhile.
    int key[kRounds], pos[kRounds];
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const unsigned t = (unsigned)next[k] - (unsigned)lo;   // < nt: lands
      key[k] = t < (unsigned)nt ? (int)t : -1;
      next[k] = warp * (kChunk / kWarps) + k * 32 + lane < m - base - kChunk
                    ? mine[base + kChunk + k * 32]
                    : -1;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const unsigned same = __match_any_sync(kFull, key[k]);
      const int leader = __ffs(same) - 1;
      int before = 0;
      if (key[k] >= 0 && lane == leader) {
        before = cnt[warp][key[k]];
        cnt[warp][key[k]] = before + __popc(same);
      }
      pos[k] = __shfl_sync(kFull, before, leader) + __popc(same & below);
      __syncwarp();
    }
    __syncthreads();

    // Target t's ids take places [start[t], start[t + 1]); warp w's of them
    // follow those of warps < w.
    int total = 0;
    if (tid < nt) {
      for (int w = 0; w < kWarps; ++w) {
        const int n_w = cnt[w][tid];
        cnt[w][tid] = total;
        total += n_w;
      }
    }
    int incl = total;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int x = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += x;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int prev = 0;
    for (int w = 0; w < warp; ++w) prev += wsum[w];
    if (tid < nt) start[tid] = prev + incl - total;
    if (tid == kThreads - 1) start[nt] = prev + incl;
    __syncthreads();
    if (start[nt] == 0) continue;                   // nothing lands here

#pragma unroll
    for (int k = 0; k < kRounds; ++k)
      if (key[k] >= 0)
        order[start[key[k]] + cnt[warp][key[k]] + pos[k]] =
            warp * (kChunk / kWarps) + k * 32 + lane;
    __syncthreads();

    // The whole block asks L2 for every landed row of the chunk (its
    // channels, 128-byte lines); then each owner adds its target's rows in
    // their sorted order, eight row loads in flight, so that a target with
    // hundreds of rows (the ball query's repeat-fill) waits on one L2
    // round trip per eight rows.
    const float* vl = vals + ((size_t)b * m + base) * c + cb * gb * kVec;
    const int span = min(gb * kVec, c - cb * gb * kVec);  // floats a row
    const int lines = (span + 31) / 32;
    for (int e = tid; e < start[nt] * lines; e += kThreads) {
      const int k = e / lines;
      prefetch_l2(vl + (size_t)order[k] * c + (e - k * lines) * 32);
    }
    if (owner) {
      const float* vc = vl + (tid % gb) * kVec;
#pragma unroll
      for (int s = 0; s < kMaxSlots; ++s) {
        const int row = j + s * per_pass;
        if (s >= slots || row >= nt) continue;
        int k = start[row];
        const int stop = start[row + 1];
        for (; k + kBatch <= stop; k += kBatch) {
          V v[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            v[u] = *reinterpret_cast<const V*>(vc +
                                               (size_t)order[k + u] * c);
#pragma unroll
          for (int u = 0; u < kBatch; ++u) add_to(acc[s], v[u]);
        }
        for (; k < stop; ++k)
          add_to(acc[s],
                 *reinterpret_cast<const V*>(vc + (size_t)order[k] * c));
      }
    }
    __syncthreads();
  }

  if (!owner) return;
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) {
    const int row = j + s * per_pass;
    if (s < slots && row < nt)
      *reinterpret_cast<V*>(out + ((size_t)b * r + lo + row) * c +
                            g * kVec) = acc[s];
  }
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

// Lanes a row takes: 1 for a row of at most four units, else the power
// of two at or above its units, at most 32 (as log2).
int lane_shift(int units) {
  if (units <= 4) return 0;
  int shift = 0;
  while (shift < 5 && (1 << shift) < units) ++shift;
  return shift;
}

template <typename V>
int launch_gather(const void* src, const void* idx, void* out, int b, int n,
                  int m, int row_bytes, cudaStream_t s) {
  const int units = row_bytes / (int)sizeof(V);
  const int shift = lane_shift(units);
  const int rows = b * m;
  // One row a thread for narrow rows, two rows a lane group for wide
  // (measured against one persistent grid and four rows: the more
  // threads, the better on the path's shapes).
  const int per_tile = shift == 0 ? kGatherThreads
                                  : (kGatherThreads >> shift) * 2;
  const int tiles = (rows + per_tile - 1) / per_tile;
  if (shift == 0)
    gather_kernel<V, 1, 4><<<tiles, kGatherThreads, 0, s>>>(
        static_cast<const V*>(src), static_cast<const int*>(idx),
        static_cast<V*>(out), n, m, rows, units, 0);
  else
    gather_kernel<V, 2, 1><<<tiles, kGatherThreads, 0, s>>>(
        static_cast<const V*>(src), static_cast<const int*>(idx),
        static_cast<V*>(out), n, m, rows, units, shift);
  return (int)cudaGetLastError();
}

template <typename V>
int launch_scatter(const void* vals, const void* idx, void* out, int b, int m,
                   int r, int c, cudaStream_t s) {
  const int groups = c / (int)(sizeof(V) / sizeof(float));
  const int gb = groups < 32 ? groups : 32;       // groups a block owns
  const int per_pass = kThreads / gb;             // target rows a pass
  const int cblocks = (groups + gb - 1) / gb;
  // Up to four target rows a thread; fewer where that leaves the card with
  // under two blocks a multiprocessor (fewer, fuller blocks re-read and
  // re-sort fewer ids; measured on the three PointNet++ gradient shapes).
  int slots = kMaxTile / per_pass < kMaxSlots ? kMaxTile / per_pass
                                              : kMaxSlots;
  auto tiles = [&](int sl) {
    const long long rows = (long long)per_pass * sl;
    return (r + rows - 1) / rows;
  };
  while (slots > 1 && b * tiles(slots) * cblocks < 2LL * multiprocessors())
    --slots;
  if (tiles(slots) * cblocks > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles(slots) * cblocks),
                  (unsigned)(b < 65535 ? b : 65535),
                  (unsigned)((b + 65534) / 65535));
  scatter_kernel<V><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(vals), static_cast<const int*>(idx),
      static_cast<float*>(out), b, m, r, c, groups, gb, per_pass, slots,
      cblocks);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns the cudaError_t
// of its launch; 0 means it was accepted.

// Every argument is one 64-bit word (the sizes as long long), which is
// what ctypes passes quickest. elem_bytes: 4 for f32, 2 for bf16 (copied
// as 16-bit words). The caller keeps b * n * c and b * m * c below 2^31.
extern "C" int lisec_gather_rows(const void* src, const void* idx, void* out,
                                 long long b, long long n, long long m,
                                 long long c, long long elem_bytes,
                                 void* stream) {
  if (b < 1 || n < 1 || m < 1 || c < 1 || (elem_bytes != 4 &&
                                             elem_bytes != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_bytes = (int)(c * elem_bytes);
  const int B = (int)b, N = (int)n, M = (int)m;
  const uintptr_t at = reinterpret_cast<uintptr_t>(src) |
                       reinterpret_cast<uintptr_t>(out) | row_bytes;
  if (at % 16 == 0)
    return launch_gather<uint4>(src, idx, out, B, N, M, row_bytes, s);
  if (at % 8 == 0)
    return launch_gather<uint2>(src, idx, out, B, N, M, row_bytes, s);
  if (at % 4 == 0)
    return launch_gather<uint32_t>(src, idx, out, B, N, M, row_bytes, s);
  return launch_gather<uint16_t>(src, idx, out, B, N, M, row_bytes, s);
}

// features may be null (c = 0). The caller keeps b * n * c and
// b * mk * (3 + c) below 2^31, and mk a multiple of k.
extern "C" int lisec_group_rows(const void* xyz, const void* features,
                                const void* centres, const void* idx,
                                void* out, long long b, long long n,
                                long long mk, long long k, long long c,
                                void* stream) {
  if (b < 1 || n < 1 || mk < 1 || k < 1 || mk % k != 0 || c < 0 ||
      (c > 0) != (features != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = (int)(b * mk);
  const float* x = static_cast<const float*>(xyz);
  const float* f = static_cast<const float*>(features);
  const float* ctr = static_cast<const float*>(centres);
  const int* ids = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  const int N = (int)n, MK = (int)mk, K = (int)k, C = (int)c;
  constexpr int kRows = 2;
  if (C == 0) {
    const int tiles = (rows + kRows * kGatherThreads - 1) /
                      (kRows * kGatherThreads);
    group_kernel<false, kRows, 1><<<tiles, kGatherThreads, 0, s>>>(
        x, f, ctr, ids, o, N, MK, K, 0, rows, 0);
  } else {
    // Lanes a row: the power of two at or above C, from 4 (the three
    // coordinates' lanes) to 32.
    int shift = 2;
    while (shift < 5 && (1 << shift) < C) ++shift;
    const int per_tile = (kGatherThreads >> shift) * kRows;
    const int tiles = (rows + per_tile - 1) / per_tile;
    group_kernel<true, kRows, 4><<<tiles, kGatherThreads, 0, s>>>(
        x, f, ctr, ids, o, N, MK, K, C, rows, shift);
  }
  return (int)cudaGetLastError();
}

extern "C" int lisec_scatter_rows(const void* vals, const void* idx,
                                  void* out, long long b, long long m,
                                  long long r, long long c, void* stream) {
  if (b < 1 || m < 1 || r < 1 || c < 1 || b > 2147483647ll ||
      m > 2147483647ll || r > 2147483647ll || c > 2147483647ll)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = (int)b, M = (int)m, R = (int)r, C = (int)c;
  if (C % 4 == 0 && aligned16(vals) && aligned16(out))
    return launch_scatter<float4>(vals, idx, out, B, M, R, C, s);
  return launch_scatter<float>(vals, idx, out, B, M, R, C, s);
}
