// Block-greedy rotated NMS of S independent streams, every round on the
// card: one launch, one block a stream.
//
// The same function as lisec_tpu_torch/ops/nms.py::_run_streams, its
// plain version; the wrapper, its bound and the design notes are in
// lisec_tpu_torch/ops/cuda/rotated_nms.py. No TPU kernel is replaced:
// the JAX package runs NMS as XLA code (lisec_tpu/ops/nms.py).
//
// Stream s holds P candidates sorted by score: boxes (S, P, 7) f32, keys
// (S, P) int32 or int64 (boxes of different keys never suppress each
// other), half_diag (S, P) f32, scores (S, P) f32 and alive (S, P) bool.
// Each round:
//  1. the block is the first `block` alive slots in index order (the
//     top-`block` alive scores under the stable tie order); a member is
//     ready iff it is filled and its score is above score_thr;
//  2. a ready member is emitted iff no earlier emitted member of its key
//     has IoU(earlier, member) > iou_thr (the full pairwise IoU);
//  3. each emitted member is killed, and kills every alive candidate c
//     of its key with IoU(member, c) > iou_thr among its k_near nearest:
//     the smallest dx*dx + dy*dy (ties by the lower index) inside the
//     circle d2 < (hd_m + hd_c)^2, ranked over every candidate of the
//     key, alive or dead; in full mode (k_near 0) among every candidate
//     of the key;
//  4. the emissions are appended in block order up to `post`; the stream
//     stops when its last block member is not ready or it holds `post`.
// Kills of a round that ends its stream change no output and are
// skipped.
//
// Layout: the stream's boxes, half-diagonals and keys are staged in
// shared memory, with an alive bit a candidate. Per round, in phases
// separated by barriers: warp 0 finds the block by popcounts and a warp
// scan over the alive words (from the first word that still holds one);
// one thread per member pair computes the in-block IoUs into suppression
// masks; thread 0 runs the emissions over the masks; then the kills. A
// member's circle hits are counted and appended to its list in one pass
// (atomics in shared memory); where they number more than k_near, a
// radix select over the bits of d2 (four passes of 8 bits, one
// histogram a member) finds the k_near-th smallest d2 and one warp
// takes its ties in index order. One thread per (member, candidate)
// pair of the lists computes the IoU and clears the alive bit. The
// pair IoU is csrc/rotated_iou.cuh, built with -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rotated_iou.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlock = 32;
constexpr unsigned kFull = 0xffffffffu;
// Shared memory for the members' histograms and near lists.
constexpr size_t kWorkBytes = 48 * 1024;
// The entry's code for a stream too large for shared memory.
constexpr int kDoesNotFit = -1;

struct Shared {
  int member[kMaxBlock];     // the round's block: candidate slots
  unsigned sup[kMaxBlock];   // bit j of sup[i]: member j suppresses i
  int emit[kMaxBlock];       // emitted members' slots, in order
  int cnt[kMaxBlock];        // near-list lengths of a group of members
  int off[kMaxBlock + 1];    // their prefix sums (pairs)
  unsigned prefix[kMaxBlock];  // radix select: d2 bits fixed so far
  int rem[kMaxBlock];          // and how many are still to take
  unsigned ready;            // bit i: member i filled and above the score
  int n_emit, j, cursor, go, kill;
};

size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

struct Carve {
  size_t box, hd, key, alive, hist, list, total;
};

// Offsets of the dynamic shared memory: boxes (P x 7 f32), half_diag,
// keys, the alive words, then `group` histograms of 256 words and
// `group` near lists of k_near ints.
Carve carve(int p, int k_near, int full, int key_bytes, int group) {
  Carve c;
  c.box = 0;
  c.hd = align16(c.box + size_t(p) * 7 * sizeof(float));
  c.key = align16(c.hd + size_t(p) * sizeof(float));
  c.alive = align16(c.key + size_t(p) * key_bytes);
  c.hist = align16(c.alive + size_t((p + 31) / 32) * sizeof(unsigned));
  const size_t hist_bytes = full ? 0 : size_t(group) * 256 * sizeof(unsigned);
  c.list = align16(c.hist + hist_bytes);
  c.total = c.list + (full ? 0 : size_t(group) * k_near * sizeof(int));
  return c;
}

// Members whose histograms and near lists fit kWorkBytes at once (>= 1).
int group_size(int block, int k_near, int full) {
  if (full) return block;
  const size_t per = 256 * sizeof(unsigned) + size_t(k_near) * sizeof(int);
  const size_t g = kWorkBytes / per;
  return g < 1 ? 1 : (g > size_t(block) ? block : int(g));
}

// The circle prefilter of member m against candidate n: same key and
// d2 < (hd_m + hd_n)^2, with d2 = dx*dx + dy*dy, dx = x_m - x_n.
template <typename Key>
__device__ __forceinline__ bool near_hit(const float* box, const float* hd,
                                         const Key* key, float mx, float my,
                                         float mh, Key mk, int n,
                                         float* d2_out) {
  if (key[n] != mk) return false;
  const float dx = mx - box[n * 7];
  const float dy = my - box[n * 7 + 1];
  const float d2 = dx * dx + dy * dy;
  const float rad = mh + hd[n];
  *d2_out = d2;
  return d2 < rad * rad;
}

__device__ __forceinline__ bool is_alive(const unsigned* alive, int n) {
  return (alive[n >> 5] >> (n & 31)) & 1u;
}

__device__ __forceinline__ void clear_alive(unsigned* alive, int n) {
  atomicAnd(&alive[n >> 5], ~(1u << (n & 31)));
}

// Warp 0: the first `block` alive slots from the cursor word on, and the
// members' ready bits.
__device__ void pick_block(Shared& sh, const unsigned* alive,
                           const float* __restrict__ scores, int words,
                           int block, float score_thr) {
  const int lane = threadIdx.x & 31;
  int got = 0;
  bool first = false;
  int cursor = words;
  for (int base = sh.cursor; got < block && base < words; base += 32) {
    const int w = base + lane;
    unsigned bits = w < words ? alive[w] : 0u;
    const int c = __popc(bits);
    int incl = c;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    if (!first) {
      const unsigned nz = __ballot_sync(kFull, bits != 0u);
      if (nz) {
        first = true;
        cursor = base + __ffs(nz) - 1;
      }
    }
    int r = got + incl - c;
    while (bits && r < block) {
      sh.member[r++] = w * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
    }
    got += total;
  }
  __syncwarp();
  if (lane == 0) sh.cursor = cursor;
  const int filled = got < block ? got : block;
  const bool ready =
      lane < filled && scores[sh.member[lane]] > score_thr;
  const unsigned rb = __ballot_sync(kFull, ready);
  if (lane == 0) sh.ready = rb;
  sh.sup[lane] = 0u;
}

// The near lists of members g0 .. g0 + ge - 1 of the round's emissions:
// every circle hit when they number at most k_near, else the k_near
// nearest by (d2, index). Leaves sh.cnt[e] = the list's length.
template <typename Key>
__device__ void near_lists(Shared& sh, const float* box, const float* hd,
                           const Key* key, unsigned* hist, int* list, int p,
                           int k_near, int g0, int ge) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid < ge) sh.cnt[tid] = 0;
  __syncthreads();
  for (int e = 0; e < ge; ++e) {
    const int m = sh.emit[g0 + e];
    const float mx = box[m * 7], my = box[m * 7 + 1], mh = hd[m];
    const Key mk = key[m];
    for (int n = tid; n < p; n += kThreads) {
      float d2;
      if (near_hit(box, hd, key, mx, my, mh, mk, n, &d2)) {
        const int c = atomicAdd(&sh.cnt[e], 1);
        if (c < k_near) list[e * k_near + c] = n;
      }
    }
  }
  __syncthreads();
  unsigned over = 0u;
  for (int e = 0; e < ge; ++e)
    if (sh.cnt[e] > k_near) over |= 1u << e;
  if (!over) return;

  // Radix select of the k_near-th smallest d2 (its bits, as d2 >= 0) of
  // each member with too many hits, 8 bits a pass from the top.
  if (tid < ge) {
    sh.prefix[tid] = 0u;
    sh.rem[tid] = k_near;
  }
  unsigned mask = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int q = tid; q < ge * 256; q += kThreads) hist[q] = 0u;
    __syncthreads();
    for (int e = 0; e < ge; ++e) {
      if (!((over >> e) & 1u)) continue;
      const int m = sh.emit[g0 + e];
      const float mx = box[m * 7], my = box[m * 7 + 1], mh = hd[m];
      const Key mk = key[m];
      const unsigned pre = sh.prefix[e];
      for (int n = tid; n < p; n += kThreads) {
        float d2;
        if (near_hit(box, hd, key, mx, my, mh, mk, n, &d2)) {
          const unsigned bits = __float_as_uint(d2);
          if ((bits & mask) == pre)
            atomicAdd(&hist[e * 256 + ((bits >> shift) & 255u)], 1u);
        }
      }
    }
    __syncthreads();
    for (int e = warp; e < ge; e += kWarps) {
      if (!((over >> e) & 1u)) continue;
      // Lane l holds bins 8l .. 8l + 7; the digit is the bin where the
      // running count reaches rem.
      unsigned h[8];
      unsigned sum = 0u;
      for (int b = 0; b < 8; ++b) {
        h[b] = hist[e * 256 + lane * 8 + b];
        sum += h[b];
      }
      const unsigned rem = unsigned(sh.rem[e]);
      unsigned incl = sum;
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      __syncwarp();
      unsigned acc = incl - sum;
      if (acc < rem && rem <= incl) {
        for (int b = 0; b < 8; ++b) {
          if (acc + h[b] >= rem) {
            sh.prefix[e] |= unsigned(lane * 8 + b) << shift;
            sh.rem[e] = int(rem - acc);
            break;
          }
          acc += h[b];
        }
      }
    }
    mask |= 255u << shift;
    __syncthreads();
  }

  // The list: every hit with d2 below the selected value, then its ties
  // in index order until k_near.
  if (tid < ge && ((over >> tid) & 1u)) sh.cnt[tid] = 0;
  __syncthreads();
  for (int e = 0; e < ge; ++e) {
    if (!((over >> e) & 1u)) continue;
    const int m = sh.emit[g0 + e];
    const float mx = box[m * 7], my = box[m * 7 + 1], mh = hd[m];
    const Key mk = key[m];
    const unsigned t = sh.prefix[e];
    for (int n = tid; n < p; n += kThreads) {
      float d2;
      if (near_hit(box, hd, key, mx, my, mh, mk, n, &d2) &&
          __float_as_uint(d2) < t)
        list[e * k_near + atomicAdd(&sh.cnt[e], 1)] = n;
    }
  }
  for (int e = warp; e < ge; e += kWarps) {
    if (!((over >> e) & 1u)) continue;
    const int m = sh.emit[g0 + e];
    const float mx = box[m * 7], my = box[m * 7 + 1], mh = hd[m];
    const Key mk = key[m];
    const unsigned t = sh.prefix[e];
    const int need = sh.rem[e];
    int taken = 0;
    for (int n0 = 0; n0 < p && taken < need; n0 += 32) {
      const int n = n0 + lane;
      float d2 = 0.0f;
      const bool tie = n < p &&
                       near_hit(box, hd, key, mx, my, mh, mk, n, &d2) &&
                       __float_as_uint(d2) == t;
      const unsigned b = __ballot_sync(kFull, tie);
      const int rank = __popc(b & ((1u << lane) - 1u));
      if (tie && taken + rank < need)
        list[e * k_near + (k_near - need) + taken + rank] = n;
      taken += __popc(b);
    }
  }
  __syncthreads();
  if (tid < ge && ((over >> tid) & 1u)) sh.cnt[tid] = k_near;
  __syncthreads();
}

template <typename Key>
__global__ void __launch_bounds__(kThreads, 1)
rotated_nms_kernel(const uint8_t* __restrict__ alive_in,
                   const float* __restrict__ scores,
                   const float* __restrict__ boxes,
                   const Key* __restrict__ keys,
                   const float* __restrict__ half_diag,
                   long long* __restrict__ out_idx,
                   uint8_t* __restrict__ out_valid, int p, int block,
                   int k_near, int full, int post, int group, float iou_thr,
                   float score_thr, Carve c) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  float* box = reinterpret_cast<float*>(smem + c.box);
  float* hd = reinterpret_cast<float*>(smem + c.hd);
  Key* key = reinterpret_cast<Key*>(smem + c.key);
  unsigned* alive = reinterpret_cast<unsigned*>(smem + c.alive);
  unsigned* hist = reinterpret_cast<unsigned*>(smem + c.hist);
  int* list = reinterpret_cast<int*>(smem + c.list);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int words = (p + 31) >> 5;
  const long long row = (long long)blockIdx.x * p;
  scores += row;
  out_idx += (long long)blockIdx.x * post;
  out_valid += (long long)blockIdx.x * post;

  for (int i = tid; i < p * 7; i += kThreads) box[i] = boxes[row * 7 + i];
  for (int i = tid; i < p; i += kThreads) {
    hd[i] = half_diag[row + i];
    key[i] = keys[row + i];
  }
  for (int base = warp * 32; base < words * 32; base += kThreads) {
    const int n = base + lane;
    const unsigned w = __ballot_sync(kFull, n < p && alive_in[row + n]);
    if (lane == 0) alive[base >> 5] = w;
  }
  for (int i = tid; i < post; i += kThreads) {
    out_idx[i] = 0;
    out_valid[i] = 0;
  }
  if (tid == 0) {
    sh.j = 0;
    sh.cursor = 0;
    sh.go = post > 0;
  }
  __syncthreads();

  while (sh.go) {
    // 1. The block.
    if (warp == 0) pick_block(sh, alive, scores, words, block, score_thr);
    __syncthreads();
    const unsigned ready = sh.ready;

    // 2. In-block suppression: IoU(earlier j, later i), same key.
    for (int q = tid; q < block * block; q += kThreads) {
      const int i = q / block;
      const int jj = q - i * block;
      if (jj < i && ((ready >> i) & 1u) && ((ready >> jj) & 1u)) {
        const int mi = sh.member[i], mj = sh.member[jj];
        if (key[mi] == key[mj] &&
            lisec_iou::pair_iou(box + mj * 7, box + mi * 7) > iou_thr)
          atomicOr(&sh.sup[i], 1u << jj);
      }
    }
    __syncthreads();

    // 3. Emissions in block order; each emitted member is dead.
    if (tid == 0) {
      unsigned em = 0u;
      int ne = 0;
      int j = sh.j;
      for (int i = 0; i < block; ++i) {
        if (!((ready >> i) & 1u) || (sh.sup[i] & em)) continue;
        em |= 1u << i;
        const int m = sh.member[i];
        sh.emit[ne++] = m;
        if (j < post) {
          out_idx[j] = m;
          out_valid[j] = 1;
          ++j;
        }
        alive[m >> 5] &= ~(1u << (m & 31));
      }
      sh.n_emit = ne;
      sh.j = j;
      sh.go = ((ready >> (block - 1)) & 1u) && j < post;
      sh.kill = sh.go && ne > 0;
    }
    __syncthreads();
    if (!sh.kill) continue;

    // 4. Kills.
    const int ne = sh.n_emit;
    if (full) {
      for (int q = tid; q < ne * p; q += kThreads) {
        const int e = q / p;
        const int n = q - e * p;
        const int m = sh.emit[e];
        if (key[n] == key[m] && is_alive(alive, n) &&
            lisec_iou::pair_iou(box + m * 7, box + n * 7) > iou_thr)
          clear_alive(alive, n);
      }
    } else {
      for (int g0 = 0; g0 < ne; g0 += group) {
        const int ge = ne - g0 < group ? ne - g0 : group;
        near_lists(sh, box, hd, key, hist, list, p, k_near, g0, ge);
        if (tid == 0) {
          int acc = 0;
          for (int e = 0; e < ge; ++e) {
            sh.off[e] = acc;
            acc += sh.cnt[e] < k_near ? sh.cnt[e] : k_near;
          }
          sh.off[ge] = acc;
        }
        __syncthreads();
        const int total = sh.off[ge];
        for (int q = tid; q < total; q += kThreads) {
          int e = 0;
          while (sh.off[e + 1] <= q) ++e;
          const int n = list[e * k_near + (q - sh.off[e])];
          const int m = sh.emit[g0 + e];
          if (is_alive(alive, n) &&
              lisec_iou::pair_iou(box + m * 7, box + n * 7) > iou_thr)
            clear_alive(alive, n);
        }
        __syncthreads();
      }
    }
    __syncthreads();
  }
}

template <typename Key>
int launch(const void* alive, const void* scores, const void* boxes,
           const void* keys, const void* half_diag, void* out_idx,
           void* out_valid, int s, int p, int block, int k_near, int full,
           int post, float iou_thr, float score_thr, cudaStream_t stream) {
  const int group = group_size(block, k_near, full);
  const Carve c = carve(p, k_near, full, sizeof(Key), group);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (c.total + sizeof(Shared) > size_t(optin)) return kDoesNotFit;
  err = cudaFuncSetAttribute(rotated_nms_kernel<Key>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)c.total);
  if (err != cudaSuccess) return (int)err;
  rotated_nms_kernel<Key><<<(unsigned)s, kThreads, c.total, stream>>>(
      static_cast<const uint8_t*>(alive), static_cast<const float*>(scores),
      static_cast<const float*>(boxes), static_cast<const Key*>(keys),
      static_cast<const float*>(half_diag),
      static_cast<long long*>(out_idx), static_cast<uint8_t*>(out_valid), p,
      block, k_near, full, post, group, iou_thr, score_thr, c);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) a stream of P candidates takes; 0 where it does
// not fit the current card.
extern "C" long long lisec_rotated_nms_smem(long long p, long long block,
                                            long long k_near, long long full,
                                            long long key_bytes) {
  const int group = group_size((int)block, (int)k_near, (int)full);
  const Carve c = carve((int)p, (int)k_near, (int)full, (int)key_bytes,
                        group);
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      c.total + sizeof(Shared) > size_t(optin))
    return 0;
  return (long long)c.total;
}

extern "C" int lisec_rotated_nms(const void* alive, const void* scores,
                                 const void* boxes, const void* keys,
                                 const void* half_diag, void* out_idx,
                                 void* out_valid, long long s, long long p,
                                 long long block, long long k_near,
                                 long long full, long long post,
                                 long long key_int64, float iou_thr,
                                 float score_thr, void* stream) {
  if (s < 1 || s > 0x7fffffffLL || p < 1 || p > (1LL << 24) || block < 1 ||
      block > kMaxBlock || block > p || post < 0 || post > (1LL << 30) ||
      (!full && (k_near < 1 || k_near >= p)))
    return (int)cudaErrorInvalidValue;
  if (full) k_near = p;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (key_int64)
    return launch<long long>(alive, scores, boxes, keys, half_diag, out_idx,
                             out_valid, (int)s, (int)p, (int)block,
                             (int)k_near, (int)full, (int)post, iou_thr,
                             score_thr, st);
  return launch<int>(alive, scores, boxes, keys, half_diag, out_idx,
                     out_valid, (int)s, (int)p, (int)block, (int)k_near,
                     (int)full, (int)post, iou_thr, score_thr, st);
}
