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

extern "C" int lisec_scatter_rows(const void* vals, const void* idx,
                                  void* out, int b, int m, int r, int c,
                                  void* stream) {
  if (b < 1 || m < 1 || r < 1 || c < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % 4 == 0 && aligned16(vals) && aligned16(out))
    return launch_scatter<float4>(vals, idx, out, b, m, r, c, s);
  return launch_scatter<float>(vals, idx, out, b, m, r, c, s);
}
