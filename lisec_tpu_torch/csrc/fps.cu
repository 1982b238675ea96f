// Farthest-point sampling for Hopper.
//
// Replaces lisec_tpu/ops/pallas/fps_kernel.py::fps_pallas (bodies
// _fps_batched_kernel and _fps_kernel). The wrapper, its bound and the
// design notes are in lisec_tpu_torch/ops/cuda/fps.py.
//
// For each cloud b, with points (N, 3) f32 and a validity mask (N,):
//
//   out[b, 0] = the lowest valid index, or 0 when no point is valid
//   dist[j]   = +inf-like for a valid point; a masked point has none
//   for i in 1 .. M-1:
//     dist[j]   = min(dist[j], ((x_j-x_l)^2 + (y_j-y_l)^2) + (z_j-z_l)^2)
//                 for every valid j, l = out[b, i-1]
//     out[b, i] = argmax over the valid j of dist[j], the lowest j winning
//                 a tie (the lowest index of all when no point is valid)
//
// and, where asked, the picked points' xyz and mask: out_xyz[b, i] =
// points[b, out[b, i]], out_mask[b, i] = mask[b, out[b, i]].
//
// One thread block owns one cloud for all M rounds; the rounds are
// sequential, so the latency of one round is the whole cost. A round is
// built for that latency:
//
// * State in registers: a block of 256 threads, thread t holding points
//   t * PPT .. t * PPT + PPT - 1 (x, y, z and running distance; PPT <= 8)
//   for N <= 2048. A masked point keeps distance -1, which the update's
//   min leaves alone, so the update has no test. Above 2048 points the
//   points live in shared memory as float4 {x, y, z, dist} (16 bytes a
//   point, N <= 14,336), point j with thread j % 1024 of 1024, with the
//   same round.
// * One 32-bit key a point: valid ? bits(dist) + 1 : 0. Valid distances
//   are >= +0, so their f32 bits order as unsigned ints, and a valid point
//   at distance 0 still beats a masked one. A thread finds its best point
//   with a tree over its distances that keeps the lower index on a tie.
//   On the register route indices rise with the thread, so a warp's
//   winner is __reduce_max_sync on the key and the first lane holding it
//   (a ballot), and the block's the first warp holding the largest; on the
//   shared route a warp takes __reduce_min_sync of the index over the
//   lanes holding the largest key.
// * One barrier a round: each warp's winning lane writes (key, index)
//   into a shared slot chosen by the round's parity, and after the barrier
//   every thread reduces all the slots itself (on the register route
//   eight slots as two vector loads and a tree), so no second barrier and
//   no broadcast of the pick are needed. The parity makes it race-free: a
//   warp reaches round i+2's write only after every warp has passed round
//   i+1's barrier, and so has read round i's slots.
// * The pick's coordinates come from a read-only shared copy of the
//   cloud's xyz (a broadcast read); the winner's key says whether it is
//   valid, so the picked mask costs no load.
//
// The distance is written with __fsub_rn / __fmul_rn / __fadd_rn so that
// nvcc does not contract it into FMAs: the reference rounds every product
// and sum, and one ulp changes an argmax and every pick after it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRegThreads = 256;
constexpr int kMaxPpt = 8;
constexpr int kRegPoints = kRegThreads * kMaxPpt;   // 2048
constexpr int kSmemThreads = 1024;
constexpr int kMaxPoints = 14336;                   // 16 bytes a point
constexpr float kValid = 3.0e38f;   // initial distance of a valid point
constexpr float kMasked = -1.0f;    // a masked point (or none) for good
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;

__device__ __forceinline__ float dist2(float x, float y, float z, float4 l) {
  const float dx = __fsub_rn(x, l.x);
  const float dy = __fsub_rn(y, l.y);
  const float dz = __fsub_rn(z, l.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ unsigned key_of(float d) {
  return d >= 0.0f ? __float_as_uint(d) + 1u : 0u;
}

// (key, index) winner slots of the warps, double-buffered by round parity.
struct Slots {
  unsigned key[2][32];
  unsigned idx[2][32];
};

// The block's argmax of (key, idx) over its threads: the largest key, the
// lowest index among equal keys. Every warp returns the same winner. One
// barrier.
__device__ __forceinline__ void block_argmax(unsigned key, unsigned idx,
                                             Slots& s, int parity,
                                             int nwarps, unsigned& wkey,
                                             unsigned& widx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned k = __reduce_max_sync(kFull, key);
  const unsigned i = __reduce_min_sync(kFull, key == k ? idx : kNone);
  if (lane == 0) {
    s.key[parity][warp] = k;
    s.idx[parity][warp] = i;
  }
  __syncthreads();
  const unsigned k2 = lane < nwarps ? s.key[parity][lane] : 0u;
  const unsigned i2 = lane < nwarps ? s.idx[parity][lane] : kNone;
  wkey = __reduce_max_sync(kFull, k2);
  widx = __reduce_min_sync(kFull, k2 == wkey ? i2 : kNone);
}

__device__ __forceinline__ void write_pick(int* o, float* oxyz,
                                           unsigned char* omask, int i,
                                           unsigned widx, unsigned wkey,
                                           float4 l) {
  o[i] = (int)widx;
  if (oxyz) {
    oxyz[3 * i] = l.x;
    oxyz[3 * i + 1] = l.y;
    oxyz[3 * i + 2] = l.z;
  }
  if (omask) omask[i] = wkey != 0u;
}

// The better of (key, idx) and (key2, idx2) where idx < idx2: the
// larger key, the first on a tie.
__device__ __forceinline__ void keep_first_max(unsigned& key, unsigned& idx,
                                               unsigned key2, unsigned idx2) {
  const bool take = key2 > key;
  key = take ? key2 : key;
  idx = take ? idx2 : idx;
}

// The block's argmax for threads whose point indices rise with the thread
// (thread t owns a run below thread t + 1's): a warp's winner is its
// first lane holding the largest key, and the block's the first warp's
// holding the largest; the slots are read as vectors and reduced as a
// tree in every thread. Every thread returns the same winner. One barrier.
template <int NWARPS>
__device__ __forceinline__ void block_argmax_ordered(unsigned key,
                                                     unsigned idx, Slots& s,
                                                     int parity,
                                                     unsigned& wkey,
                                                     unsigned& widx) {
  static_assert(NWARPS == 8, "the slot tree reads two uint4 a buffer");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned k = __reduce_max_sync(kFull, key);
  const unsigned first = __ffs(__ballot_sync(kFull, key == k)) - 1;
  if (lane == (int)first) {
    s.key[parity][warp] = k;
    s.idx[parity][warp] = idx;
  }
  __syncthreads();
  const uint4* kv = reinterpret_cast<const uint4*>(s.key[parity]);
  const uint4* iv = reinterpret_cast<const uint4*>(s.idx[parity]);
  const uint4 k0 = kv[0], k1 = kv[1], i0 = iv[0], i1 = iv[1];
  unsigned ka = k0.x, ia = i0.x, kb = k0.z, ib = i0.z;
  unsigned kc = k1.x, ic = i1.x, kd = k1.z, id = i1.z;
  keep_first_max(ka, ia, k0.y, i0.y);
  keep_first_max(kb, ib, k0.w, i0.w);
  keep_first_max(kc, ic, k1.y, i1.y);
  keep_first_max(kd, id, k1.w, i1.w);
  keep_first_max(ka, ia, kb, ib);
  keep_first_max(kc, ic, kd, id);
  keep_first_max(ka, ia, kc, ic);
  wkey = ka;
  widx = ia;
}

// N <= kRegThreads * PPT: points j = tid * PPT + k, k < PPT, in registers.
template <int PPT>
__global__ void __launch_bounds__(kRegThreads)
fps_reg_kernel(const float* __restrict__ points,        // (B, N, 3)
               const unsigned char* __restrict__ mask,  // (B, N) bool
               int* __restrict__ out,                   // (B, M)
               float* __restrict__ out_xyz,             // (B, M, 3) or null
               unsigned char* __restrict__ out_mask,    // (B, M) or null
               int n, int m) {
  __shared__ float4 sxyz[kRegThreads * PPT];
  __shared__ __align__(16) Slots slots;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* p = points + b * n * 3;
  const unsigned char* valid = mask + b * n;
  int* o = out + b * m;
  float* oxyz = out_xyz ? out_xyz + b * m * 3 : nullptr;
  unsigned char* omask = out_mask ? out_mask + b * m : nullptr;

  // A masked point (or none) keeps distance -1 for good: fminf(-1, d2) is
  // -1 for every d2 >= 0, so the update needs no test.
  float x[PPT], y[PPT], z[PPT], d[PPT];
  // The seed: key 1 for a valid point, 0 otherwise.
  unsigned bk = 0u, bi = (unsigned)(tid * PPT);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int j = tid * PPT + k;
    x[k] = y[k] = z[k] = 0.0f;
    d[k] = kMasked;
    if (j < n) {
      x[k] = p[3 * j];
      y[k] = p[3 * j + 1];
      z[k] = p[3 * j + 2];
      sxyz[j] = make_float4(x[k], y[k], z[k], 0.0f);
      if (valid[j]) {
        d[k] = kValid;
        if (bk == 0u) {
          bk = 1u;
          bi = (unsigned)j;
        }
      }
    }
  }
  unsigned wkey, widx;
  block_argmax_ordered<kRegThreads / 32>(bk, bi, slots, 0, wkey, widx);

  for (int i = 1;; ++i) {
    const float4 l = sxyz[widx];
    if (tid == 0) write_pick(o, oxyz, omask, i - 1, widx, wkey, l);
    if (i == m) break;
    // The update, then a tree over the thread's points for the largest
    // distance, the lower index on a tie.
    float bd[PPT];
    int bj[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      d[k] = fminf(d[k], dist2(x[k], y[k], z[k], l));
      bd[k] = d[k];
      bj[k] = k;
    }
#pragma unroll
    for (int w = 1; w < PPT; w *= 2)
#pragma unroll
      for (int k = 0; k + w < PPT; k += 2 * w)
        if (bd[k + w] > bd[k]) {
          bd[k] = bd[k + w];
          bj[k] = bj[k + w];
        }
    // Valid distances (>= +0) give bits + 1 >= 1; -1 gives a negative int.
    bk = (unsigned)max((int)__float_as_uint(bd[0]) + 1, 0);
    bi = (unsigned)(tid * PPT + bj[0]);
    block_argmax_ordered<kRegThreads / 32>(bk, bi, slots, i & 1, wkey,
                                           widx);
  }
}

// kRegPoints < N <= kMaxPoints: the points in shared memory, the same
// round under kSmemThreads threads.
__global__ void __launch_bounds__(kSmemThreads)
fps_smem_kernel(const float* __restrict__ points,
                const unsigned char* __restrict__ mask,
                int* __restrict__ out, float* __restrict__ out_xyz,
                unsigned char* __restrict__ out_mask, int n, int m) {
  extern __shared__ float4 pts[];   // {x, y, z, dist}
  __shared__ Slots slots;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* p = points + b * n * 3;
  const unsigned char* valid = mask + b * n;
  int* o = out + b * m;
  float* oxyz = out_xyz ? out_xyz + b * m * 3 : nullptr;
  unsigned char* omask = out_mask ? out_mask + b * m : nullptr;

  unsigned bk = 0u, bi = (unsigned)tid;
  for (int j = tid; j < n; j += kSmemThreads) {
    const bool ok = valid[j] != 0;
    pts[j] = make_float4(p[3 * j], p[3 * j + 1], p[3 * j + 2],
                         ok ? kValid : kMasked);
    if (ok && bk == 0u) {
      bk = 1u;
      bi = (unsigned)j;
    }
  }
  unsigned wkey, widx;
  block_argmax(bk, bi, slots, 0, kSmemThreads / 32, wkey, widx);

  for (int i = 1;; ++i) {
    const float4 l = pts[widx];
    if (tid == 0) write_pick(o, oxyz, omask, i - 1, widx, wkey, l);
    if (i == m) break;
    bk = 0u;
    bi = (unsigned)tid;
    for (int j = tid; j < n; j += kSmemThreads) {
      float4 q = pts[j];
      if (q.w >= 0.0f) {
        q.w = fminf(q.w, dist2(q.x, q.y, q.z, l));
        pts[j].w = q.w;
      }
      const unsigned kk = key_of(q.w);
      if (kk > bk) {
        bk = kk;
        bi = (unsigned)j;
      }
    }
    block_argmax(bk, bi, slots, i & 1, kSmemThreads / 32, wkey, widx);
  }
}

// The round floor: M rounds of the block reduction and its barrier alone,
// at the block shape fps takes for N, with a key that depends on the last
// pick so that no round can start before the previous one ends.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
fps_floor_kernel(int* __restrict__ out, int m) {
  __shared__ __align__(16) Slots slots;
  const int tid = threadIdx.x;
  int* o = out + (size_t)blockIdx.x * m;
  unsigned wkey, widx = 0u;
  for (int i = 0; i < m; ++i) {
    const unsigned key = ((unsigned)tid * 2654435761u) ^ widx;
    if constexpr (THREADS == kRegThreads)
      block_argmax_ordered<THREADS / 32>(key, (unsigned)tid, slots, i & 1,
                                         wkey, widx);
    else
      block_argmax(key, (unsigned)tid, slots, i & 1, THREADS / 32, wkey,
                   widx);
    if (tid == 0) o[i] = (int)widx;
  }
}

// in: points, mask; o: out, out_xyz, out_mask.
template <int PPT>
cudaError_t launch_reg(const void* const in[2], void* const o[3], int b,
                       int n, int m, cudaStream_t s) {
  fps_reg_kernel<PPT><<<b, kRegThreads, 0, s>>>(
      static_cast<const float*>(in[0]),
      static_cast<const unsigned char*>(in[1]), static_cast<int*>(o[0]),
      static_cast<float*>(o[1]), static_cast<unsigned char*>(o[2]), n, m);
  return cudaGetLastError();
}

}  // namespace

// The most points a cloud may have (shared-memory route).
extern "C" int lisec_fps_max_points() { return kMaxPoints; }

// Plain C entry point (loaded with ctypes). out_xyz and out_mask may be
// null (indices only). Returns the cudaError_t of the launch; 0 means it
// was accepted.
extern "C" int lisec_fps(const void* points, const void* mask, void* out,
                         void* out_xyz, void* out_mask, int b, int n, int m,
                         void* stream) {
  if (b < 1 || n < 1 || m < 1 || n > kMaxPoints)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* in[2] = {points, mask};
  void* o[3] = {out, out_xyz, out_mask};
  if (n <= kRegThreads) return (int)launch_reg<1>(in, o, b, n, m, s);
  if (n <= 2 * kRegThreads) return (int)launch_reg<2>(in, o, b, n, m, s);
  if (n <= 4 * kRegThreads) return (int)launch_reg<4>(in, o, b, n, m, s);
  if (n <= kRegPoints) return (int)launch_reg<8>(in, o, b, n, m, s);
  const size_t smem = (size_t)n * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fps_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fps_smem_kernel<<<b, kSmemThreads, smem, s>>>(
      static_cast<const float*>(points),
      static_cast<const unsigned char*>(mask), static_cast<int*>(out),
      static_cast<float*>(out_xyz), static_cast<unsigned char*>(out_mask),
      n, m);
  return (int)cudaGetLastError();
}

// The round floor of fps at (b, n, m): out (B, M) int32 receives the
// floor's own winners (a measurement, not a result).
extern "C" int lisec_fps_round_floor(void* out, int b, int n, int m,
                                     void* stream) {
  if (b < 1 || n < 1 || m < 1 || n > kMaxPoints)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kRegPoints)
    fps_floor_kernel<kRegThreads><<<b, kRegThreads, 0, s>>>(
        static_cast<int*>(out), m);
  else
    fps_floor_kernel<kSmemThreads><<<b, kSmemThreads, 0, s>>>(
        static_cast<int*>(out), m);
  return (int)cudaGetLastError();
}
