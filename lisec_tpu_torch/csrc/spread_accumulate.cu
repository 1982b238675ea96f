// Spread-accumulate for Hopper: K row streams summed into one dense table.
//
// Replaces lisec_tpu/ops/pallas/spread_kernel.py::spread_accumulate (body
// _spread_kernel). The wrapper, its bound and the design notes are in
// lisec_tpu_torch/ops/cuda/spread_accumulate.py. The sparse conv runs the
// fused kernel further down (spread_accumulate_kernel_mma / _fma, wrapper
// lisec_tpu_torch/ops/cuda/spread_conv.py), which makes each offset's
// product itself instead of reading it from a (B, K, N, C) stream; the
// kernel below stays for streams that are not a product (range seg's kNN
// delivery).
//
//   out[b, t, :] = sum over k = 0..K-1, in that order, of
//                  vals[b, k, n, :]  where targets[b, k, n] == t
//
// for vals (B, K, N, C) bf16 or f32 and targets (B, K, N) int32 that name
// each row of [0, num_out) at most once per (b, k); any other id drops its
// row. The result is f32.
//
// The accumulate reads an inverse map in_of (B, K, num_out): the row n of
// vals[b, k] that lands on t, or -1. Two ways to it:
//  * the caller hands it over (a submanifold conv's map is its scatter
//    rulebook with k reversed): one launch, the map taken as it is;
//  * else an invert kernel builds it in scratch, whatever the scratch
//    held, without a memset: one block owns one (b, k) slice, sets it to
//    -1, waits at a barrier, then stores in_of[b, k, targets[b, k, n]] =
//    n (the targets of one (b, k) are distinct, so the stores never
//    collide): two launches. (A design that skipped the clearing and had
//    the accumulate check each entry against targets was measured slower:
//    the check is one more dependent load per landed row.)
//
// Accumulate: a warp owns 32 / L output rows, L lanes a row (a power of
// two, L * VEC >= C up to 32 lanes, 16 bytes of a value row a lane), so at
// C = 16, 32 and 64 bf16 a warp covers 16, 8 and 4 whole rows. For up to
// 32 offsets at a time the warp reads its rows' map entries in one
// coalesced load a lane (offset-major, rows fastest) and hands each row's
// entries to its lanes by shuffles; the lanes then load the landed rows
// eight offsets at a time (eight loads in flight) and add them in f32 in
// k order, so the sum is bit-equal to one index_add_ per k, and write
// their channels once, zeros included. Registers are capped so that four
// blocks fit a multiprocessor: the row loads are random, and the loads in
// flight across warps are what hides their latency. No atomics: a run
// repeats bit for bit. Offsets inside a cloud are 32-bit (the wrapper
// bounds K N C, K num_out and num_out C); a cloud's base is taken once in
// 64 bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kInFlight = 8;   // landed-row loads in flight
constexpr int kInvertThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

// Grid (K, B): block (k, b) sets in_of[b, k, :] to -1, then stores
// in_of[b, k, targets[b, k, n]] = n.
__global__ void __launch_bounds__(kInvertThreads)
spread_invert_kernel(const int* __restrict__ targets,  // (B, K, N)
                     int* __restrict__ in_of,          // (B, K, num_out)
                     int n, int num_out) {
  const size_t bk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int* tg = targets + bk * n;
  int* map = in_of + bk * num_out;
  for (int t = threadIdx.x; t < num_out; t += kInvertThreads) map[t] = -1;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kInvertThreads) {
    const int t = __ldg(tg + i);
    if (t >= 0 && t < num_out) map[t] = i;
  }
}

// What a lane loads of a value row, and how it adds that in f32.
template <typename T, int VEC>
struct Piece;

template <>
struct Piece<float, 4> {
  using V = float4;
  static __device__ __forceinline__ void add(float* acc, V v) {
    acc[0] += v.x; acc[1] += v.y; acc[2] += v.z; acc[3] += v.w;
  }
};
template <>
struct Piece<float, 1> {
  using V = float;
  static __device__ __forceinline__ void add(float* acc, V v) {
    acc[0] += v;
  }
};
template <>
struct Piece<__nv_bfloat16, 8> {
  using V = uint4;
  static __device__ __forceinline__ void add(float* acc, V v) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  }
};
template <>
struct Piece<__nv_bfloat16, 1> {
  using V = unsigned short;
  static __device__ __forceinline__ void add(float* acc, V v) {
    acc[0] += __bfloat162float(__ushort_as_bfloat16(v));
  }
};

// Grid (row tiles of kWarps * 32 / kLanes, B).
template <typename T, int VEC, int kLanes>
__global__ void __launch_bounds__(kThreads, 4)
spread_accumulate_kernel(const T* __restrict__ vals,       // (B, K, N, C)
                         const int* __restrict__ in_of,    // (B, K, num_out)
                         float* __restrict__ out,          // (B, num_out, C)
                         int k, int n, int c, int num_out) {
  using P = Piece<T, VEC>;
  using V = typename P::V;
  constexpr int kRows = 32 / kLanes;          // output rows a warp
  // Offsets whose map entries the warp holds at a time: 32, or fewer
  // where the warp owns many rows, eight registers a lane at most.
  constexpr int kOffsets = 256 / kRows < 32 ? 256 / kRows : 32;
  constexpr int kHeld = kOffsets * kRows / 32;   // entries a lane holds
  constexpr int kSpan = 32 / kRows;              // offsets a register holds
  const size_t b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int t0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  const int mine = lane / kLanes;             // this lane's row in the warp
  const int t = t0 + mine;
  const int chunks = c / VEC;
  const int passes = (chunks + kLanes - 1) / kLanes;
  const V* vb = reinterpret_cast<const V*>(vals + b * k * n * c);
  const int* mb = in_of + b * k * num_out;

  for (int pass = 0; pass < passes; ++pass) {   // the same for every lane
    const int ch = pass * kLanes + lane % kLanes;
    const bool live = ch < chunks && t < num_out;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    for (int kb = 0; kb < k; kb += kOffsets) {
      // Entry (offset kb + o, row t0 + r) sits in lane (o * kRows + r) % 32,
      // register (o * kRows + r) / 32.
      int ent[kHeld];
#pragma unroll
      for (int q = 0; q < kHeld; ++q) {
        const int e = lane + 32 * q;
        const int kk = kb + e / kRows, tt = t0 + e % kRows;
        ent[q] = kk < k && tt < num_out ? __ldg(mb + kk * num_out + tt) : -1;
      }
#pragma unroll
      for (int o0 = 0; o0 < kOffsets; o0 += kInFlight) {
        // Most offsets land nothing on a row. Where a warp owns four rows
        // or fewer (C = 64 bf16), an offset that lands on none of them
        // costs a shuffle and a vote; with more rows a warp seldom skips,
        // and the branch would only hold the loads apart (measured).
        V v[kInFlight];
        bool any[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int o = o0 + u;
          int row = __shfl_sync(kFull, ent[o / kSpan],
                                (o % kSpan) * kRows + mine);
          if (!live || row >= n) row = -1;
          any[u] = kRows > 4 || __any_sync(kFull, row >= 0);
          if (any[u])
            v[u] = row >= 0
                       ? __ldg(vb + ((kb + o) * n + row) * chunks + ch)
                       : V{};
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
          if (any[u]) P::add(acc, v[u]);
      }
    }
    if (live) {
      float* dst = out + (b * num_out + t) * c + ch * VEC;
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int i = 0; i < VEC; i += 4)
          *reinterpret_cast<float4*>(dst + i) =
              make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) dst[i] = acc[i];
      }
    }
  }
}

template <typename T, int VEC, int kLanes>
void launch(const void* vals, const int* in_of, float* out, int b, int k,
            int n, int c, int num_out, cudaStream_t s) {
  constexpr int kTile = kWarps * 32 / kLanes;   // output rows a block
  const dim3 grid((unsigned)((num_out + kTile - 1) / kTile), (unsigned)b);
  spread_accumulate_kernel<T, VEC, kLanes><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(vals), in_of, out, k, n, c, num_out);
}

// Lanes a row: the power of two at or above its chunks, at most 32.
template <typename T, int VEC>
void launch_lanes(const void* vals, const int* in_of, float* out, int b,
                  int k, int n, int c, int num_out, cudaStream_t s) {
  const int chunks = c / VEC;
  auto go = [&](auto lanes) {
    launch<T, VEC, decltype(lanes)::value>(vals, in_of, out, b, k, n, c,
                                           num_out, s);
  };
  if (chunks <= 1) go(std::integral_constant<int, 1>());
  else if (chunks <= 2) go(std::integral_constant<int, 2>());
  else if (chunks <= 4) go(std::integral_constant<int, 4>());
  else if (chunks <= 8) go(std::integral_constant<int, 8>());
  else if (chunks <= 16) go(std::integral_constant<int, 16>());
  else go(std::integral_constant<int, 32>());
}


// ---- The fused sparse conv: gather, per-offset product, spread ------------
//
//   out[b, t, :] = sum over k = 0..K-1, in that order, of
//                  f32(round_T(W_k^T x[b, in_of[b, k, t], :]))
//
// for x (B, V_in, Cin) and W (K, Cin, Cout) of one type T (bf16 or f32),
// an entry -1 (or outside [0, V_in)) reading a zero row. It replaces the
// pair that wrote every offset's product of every padded row, (B, K,
// V_in, Cout), to device memory and read the landed rows back: those
// products are made in registers here and never leave the block.
//
// Output-stationary: a block owns kTileRows output rows of one cloud and
// all Cout channels. It reads its rows' map entries for every offset
// once (coalesced), lists in k order the offsets that name a row of the
// tile, and skips the others whole (the padded tail of a list names
// none). For each listed offset it gathers the named rows of x into
// shared memory with cp.async, 16 bytes a lane (zero-filled where the
// entry is -1 or past Cin), and stages W_k beside them; a ring of S
// stages keeps the next offsets' gathers in flight while one offset's
// product runs. The product is mma.sync m16n8k16 (bf16 in, f32 sums)
// into a fresh fragment per offset and 8-column tile; the fragment is
// rounded to bf16, the type the pair stored its product in, and added
// in f32 to the running sum, in k order: the pair's rounding points, so
// only the order inside one Cin sum differs from a GEMM's. No atomics.
// Each warp owns 16 rows and NT / WN 8-column tiles; Cin is padded with
// zeros to KS * 16 and Cout to NT * 8 in shared memory, so Cin 4 or 5
// (a first conv) runs the same code, its rows copied by plain loads.
//
// f32 features take the same tiling with f32 FMAs in c order (no TF32)
// and no rounding. Bound: the map's ints, the gathered rows (mostly L2
// hits: a level's features are 2-46 MB) and the f32 table written once
// are the bytes; the MMA work is the pair's own product over the tiles'
// padded rows of the offsets not skipped.

constexpr int kTileRows = 64;   // output rows a block
constexpr int kMaxTaps = 64;    // offsets a conv (the map's shared copy)
constexpr int kMaxSmem = 232448;
static_assert(kTileRows == 64, "a warp reads a tile's entries as two rows a lane");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; `bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Bytes of the map's shared copy and the list of live offsets, rounded
// to 16.
__host__ __device__ constexpr int map_bytes(int k) {
  return ((k * kTileRows + kMaxTaps + 1) * 4 + 15) / 16 * 16;
}

// Copies the tile's map entries for every offset into idx (K x
// kTileRows; rows past num_out and entries outside [0, v_in) as -1) and
// lists in k order the offsets that name some row of the tile. Returns
// how many.
template <int kThreads>
__device__ __forceinline__ int load_tile_map(const int* __restrict__ mb,
                                             int* idx, int* live, int k,
                                             int num_out, int v_in,
                                             int t0) {
  for (int i = threadIdx.x; i < k * kTileRows; i += kThreads) {
    const int kk = i / kTileRows, t = t0 + i % kTileRows;
    const int s = t < num_out ? __ldg(mb + (size_t)kk * num_out + t) : -1;
    idx[i] = s >= 0 && s < v_in ? s : -1;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int kk = warp; kk < k; kk += kThreads / 32) {
    const int* e = idx + kk * kTileRows;
    const bool any = __any_sync(kFull, e[lane] >= 0 || e[lane + 32] >= 0);
    if (lane == 0) live[kk] = any;
  }
  __syncthreads();
  if (warp == 0) {   // compact the flags into the list, in place
    int n = 0;
    for (int kb = 0; kb < k; kb += 32) {
      const bool any = kb + lane < k && live[kb + lane];
      const unsigned m = __ballot_sync(kFull, any);
      if (any) live[n + __popc(m & ((1u << lane) - 1u))] = kb + lane;
      n += __popc(m);
    }
    if (lane == 0) live[kMaxTaps] = n;
  }
  __syncthreads();
  return live[kMaxTaps];
}

// bf16: KS 16-deep slices of Cin, NT 8-wide tiles of Cout, WN warps
// across Cout (4 across the rows), S stages.
template <int KS, int NT, int WN, int S>
__global__ void __launch_bounds__(128 * WN)
spread_accumulate_kernel_mma(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ w,
                             const int* __restrict__ in_of,
                             float* __restrict__ out, int k, int v_in,
                             int cin, int cout, int num_out, int x_vec,
                             int w_vec) {
  constexpr int kThreads = 128 * WN;
  constexpr int CP = KS * 16, NP = NT * 8, NTW = NT / WN;
  constexpr int A_LD = CP + 8, W_LD = NP + 8;   // 16 bytes of padding
  constexpr int A_ELEMS = kTileRows * A_LD, W_ELEMS = CP * W_LD;
  constexpr int STAGE = A_ELEMS + W_ELEMS;
  extern __shared__ __align__(16) unsigned char smem[];
  int* idx = reinterpret_cast<int*>(smem);
  int* live = idx + k * kTileRows;
  __nv_bfloat16* stages =
      reinterpret_cast<__nv_bfloat16*>(smem + map_bytes(k));
  const size_t b = blockIdx.y;
  const int t0 = blockIdx.x * kTileRows;
  const __nv_bfloat16* xb = x + b * v_in * cin;
  const int n_live =
      load_tile_map<kThreads>(in_of + b * k * num_out, idx, live, k,
                              num_out, v_in, t0);
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  auto fetch = [&](int i) {   // offset live[i] into stage i % S
    const int kk = live[i];
    __nv_bfloat16* a_s = stages + (i % S) * STAGE;
    __nv_bfloat16* w_s = a_s + A_ELEMS;
    const int* rows = idx + kk * kTileRows;
    if (x_vec) {
      for (int q = threadIdx.x; q < kTileRows * (CP / 8); q += kThreads) {
        const int r = q / (CP / 8), j = q % (CP / 8);
        const int src = rows[r];
        const bool ok = src >= 0 && j * 8 < cin;
        cp_async16(a_s + r * A_LD + j * 8,
                   ok ? xb + (size_t)src * cin + j * 8 : xb, ok ? 16 : 0);
      }
    } else {
      for (int q = threadIdx.x; q < kTileRows * CP; q += kThreads) {
        const int r = q / CP, c = q % CP;
        const int src = rows[r];
        a_s[r * A_LD + c] =
            src >= 0 && c < cin ? xb[(size_t)src * cin + c] : zero;
      }
    }
    const __nv_bfloat16* wk = w + (size_t)kk * cin * cout;
    if (w_vec) {
      for (int q = threadIdx.x; q < CP * (NP / 8); q += kThreads) {
        const int c = q / (NP / 8), j = q % (NP / 8);
        const bool ok = c < cin && j * 8 < cout;
        cp_async16(w_s + c * W_LD + j * 8, ok ? wk + c * cout + j * 8 : wk,
                   ok ? 16 : 0);
      }
    } else {
      for (int q = threadIdx.x; q < CP * NP; q += kThreads) {
        const int c = q / NP, n = q % NP;
        w_s[c * W_LD + n] = c < cin && n < cout ? wk[c * cout + n] : zero;
      }
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % 4, wn = warp / 4;
  float acc[NTW][4];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.0f;

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n_live) fetch(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_live; ++i) {
    if (i + S - 1 < n_live) fetch(i + S - 1);
    cp_async_commit();
    cp_async_wait<S - 1>();
    __syncthreads();
    const __nv_bfloat16* a_s = stages + (i % S) * STAGE;
    const __nv_bfloat16* w_s = a_s + A_ELEMS;
    uint32_t a[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldmatrix_x4(a[ks], a_s + (wm * 16 + (lane & 15)) * A_LD + ks * 16 +
                             (lane >> 4) * 8);
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, w_s + (ks * 16 + (lane & 15)) * W_LD +
                                  (wn * NTW + nt) * 8);
        mma_bf16(d, a[ks], bf);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[nt][j] += __bfloat162float(__float2bfloat16_rn(d[j]));
    }
    __syncthreads();
  }

  // Fragment (nt, j): row lane / 4 (+ 8 for j >= 2), column 2 (lane % 4)
  // + j % 2 of the warp's tile nt.
  const bool pairs = cout % 2 == 0;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    const int col = (wn * NTW + nt) * 8 + (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + wm * 16 + (lane >> 2) + h * 8;
      if (t >= num_out || col >= cout) continue;
      float* dst = out + (b * num_out + t) * cout + col;
      if (pairs) {
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
      } else {
        dst[0] = acc[nt][2 * h];
        if (col + 1 < cout) dst[1] = acc[nt][2 * h + 1];
      }
    }
  }
}

// f32: one offset at a time, each thread one row of the tile and half
// of the NT * 8 padded columns, the sums f32 FMAs in c order.
template <int NT>
__global__ void __launch_bounds__(128)
spread_accumulate_kernel_fma(const float* __restrict__ x,
                             const float* __restrict__ w,
                             const int* __restrict__ in_of,
                             float* __restrict__ out, int k, int v_in,
                             int cin, int cout, int num_out) {
  constexpr int kThreads = 128, NP = NT * 8, kCols = NP / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  int* idx = reinterpret_cast<int*>(smem);
  int* live = idx + k * kTileRows;
  const int a_ld = cin + 1;                    // no bank-aligned columns
  float* a_s = reinterpret_cast<float*>(smem + map_bytes(k));
  float* w_s = a_s + kTileRows * a_ld;         // cin x NP
  const size_t b = blockIdx.y;
  const int t0 = blockIdx.x * kTileRows;
  const float* xb = x + b * v_in * cin;
  const int n_live =
      load_tile_map<kThreads>(in_of + b * k * num_out, idx, live, k,
                              num_out, v_in, t0);
  const int r = threadIdx.x % kTileRows;
  const int c0 = (threadIdx.x / kTileRows) * kCols;
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.0f;
  for (int i = 0; i < n_live; ++i) {
    const int kk = live[i];
    const int* rows = idx + kk * kTileRows;
    for (int q = threadIdx.x; q < kTileRows * cin; q += kThreads) {
      const int rr = q / cin, c = q % cin;
      const int src = rows[rr];
      a_s[rr * a_ld + c] = src >= 0 ? xb[(size_t)src * cin + c] : 0.0f;
    }
    const float* wk = w + (size_t)kk * cin * cout;
    for (int q = threadIdx.x; q < cin * NP; q += kThreads) {
      const int c = q / NP, n = q % NP;
      w_s[q] = n < cout ? wk[c * cout + n] : 0.0f;
    }
    __syncthreads();
    float d[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) d[j] = 0.0f;
    for (int c = 0; c < cin; ++c) {
      const float av = a_s[r * a_ld + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        d[j] = fmaf(av, w_s[c * NP + c0 + j], d[j]);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] += d[j];
    __syncthreads();
  }
  const int t = t0 + r;
  if (t < num_out) {
    float* dst = out + (b * num_out + t) * cout;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (c0 + j < cout) dst[c0 + j] = acc[j];
  }
}

// Ring depth: as many stages as fit 48 KB, 2 to 4.
template <int KS, int NT>
constexpr int stage_count() {
  constexpr int bytes =
      2 * (kTileRows * (KS * 16 + 8) + KS * 16 * (NT * 8 + 8));
  return bytes * 4 <= 49152 ? 4 : bytes * 3 <= 49152 ? 3 : 2;
}

template <int KS, int NT>
int launch_mma(const void* x, const void* w, const int* in_of, float* out,
               int b, int k, int v_in, int cin, int cout, int num_out,
               int x_vec, int w_vec, cudaStream_t s) {
  constexpr int WN = NT >= 16 ? 2 : 1;
  constexpr int S = stage_count<KS, NT>();
  constexpr int STAGE_BYTES =
      2 * (kTileRows * (KS * 16 + 8) + KS * 16 * (NT * 8 + 8));
  auto kernel = spread_accumulate_kernel_mma<KS, NT, WN, S>;
  static bool opened = false;   // the shared-memory cap raised once
  if (!opened) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opened = true;
  }
  const int smem = map_bytes(k) + S * STAGE_BYTES;
  const dim3 grid((unsigned)((num_out + kTileRows - 1) / kTileRows),
                  (unsigned)b);
  kernel<<<grid, 128 * WN, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), in_of, out, k, v_in, cin, cout,
      num_out, x_vec, w_vec);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_fma(const void* x, const void* w, const int* in_of, float* out,
               int b, int k, int v_in, int cin, int cout, int num_out,
               cudaStream_t s) {
  auto kernel = spread_accumulate_kernel_fma<NT>;
  static bool opened = false;
  if (!opened) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opened = true;
  }
  const int smem =
      map_bytes(k) + 4 * (kTileRows * (cin + 1) + cin * NT * 8);
  const dim3 grid((unsigned)((num_out + kTileRows - 1) / kTileRows),
                  (unsigned)b);
  kernel<<<grid, 128, smem, s>>>(static_cast<const float*>(x),
                                 static_cast<const float*>(w), in_of, out,
                                 k, v_in, cin, cout, num_out);
  return (int)cudaGetLastError();
}

// The template arguments from the widths: Cin to 16, 32, 64 or 128,
// Cout to 16, 32, 64 or 128.
template <int KS>
int launch_mma_cout(const void* x, const void* w, const int* in_of,
                    float* out, int b, int k, int v_in, int cin, int cout,
                    int num_out, int x_vec, int w_vec, cudaStream_t s) {
  if (cout <= 16)
    return launch_mma<KS, 2>(x, w, in_of, out, b, k, v_in, cin, cout,
                             num_out, x_vec, w_vec, s);
  if (cout <= 32)
    return launch_mma<KS, 4>(x, w, in_of, out, b, k, v_in, cin, cout,
                             num_out, x_vec, w_vec, s);
  if (cout <= 64)
    return launch_mma<KS, 8>(x, w, in_of, out, b, k, v_in, cin, cout,
                             num_out, x_vec, w_vec, s);
  return launch_mma<KS, 16>(x, w, in_of, out, b, k, v_in, cin, cout,
                            num_out, x_vec, w_vec, s);
}

}  // namespace

// Plain C entry point (loaded with ctypes; every argument one 64-bit
// word). vals_bf16 != 0: vals is bf16, else f32. map_given != 0: in_of is
// the caller's exact inverse map and is only read; else it is scratch of
// B * K * num_out ints, whatever it holds, that the invert kernel fills.
// Returns the cudaError_t of the first launch that failed; 0 means all
// were accepted.
extern "C" int lisec_spread_accumulate(const void* vals, const void* targets,
                                       void* in_of, void* out, long long b,
                                       long long k, long long n, long long c,
                                       long long num_out, long long vals_bf16,
                                       long long map_given, void* stream) {
  if (b < 1 || k < 1 || n < 1 || c < 1 || num_out < 1 || b > 65535 ||
      k * n * c >= 2147483648ll || k * num_out >= 2147483648ll ||
      num_out * c >= 2147483648ll)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* map = static_cast<int*>(in_of);
  float* o = static_cast<float*>(out);
  const int B = (int)b, K = (int)k, N = (int)n, C = (int)c;
  const int R = (int)num_out;

  if (!map_given) {
    spread_invert_kernel<<<dim3((unsigned)K, (unsigned)B), kInvertThreads, 0,
                           s>>>(static_cast<const int*>(targets), map, N, R);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const bool aligned = reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vals_bf16) {
    if (aligned && C % 8 == 0)
      launch_lanes<__nv_bfloat16, 8>(vals, map, o, B, K, N, C, R, s);
    else
      launch_lanes<__nv_bfloat16, 1>(vals, map, o, B, K, N, C, R, s);
  } else {
    if (aligned && C % 4 == 0)
      launch_lanes<float, 4>(vals, map, o, B, K, N, C, R, s);
    else
      launch_lanes<float, 1>(vals, map, o, B, K, N, C, R, s);
  }
  return (int)cudaGetLastError();
}

// Plain C entry point of the fused sparse conv (every argument one 64-bit
// word): x (B, V_in, Cin), w (K, Cin, Cout), both bf16 (x_bf16 != 0) or
// f32; out (B, num_out, Cout) f32. map_given != 0: in_of is the caller's
// exact inverse map (B, K, num_out) and is only read; else it is scratch
// that the invert kernel fills from targets (B, K, V_in) first. Cin and
// Cout at most 128, K at most 64. Returns the cudaError_t of the first
// launch that failed; 0 means all were accepted.
extern "C" int lisec_spread_conv(const void* x, const void* w,
                                 const void* targets, void* in_of,
                                 void* out, long long b, long long k,
                                 long long v_in, long long cin,
                                 long long cout, long long num_out,
                                 long long x_bf16, long long map_given,
                                 void* stream) {
  if (b < 1 || k < 1 || v_in < 1 || cin < 1 || cout < 1 || num_out < 1 ||
      b > 65535 || k > kMaxTaps || cin > 128 || cout > 128 ||
      k * v_in >= 2147483648ll || k * num_out >= 2147483648ll ||
      v_in * cin >= 2147483648ll || num_out * cout >= 2147483648ll)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* map = static_cast<int*>(in_of);
  float* o = static_cast<float*>(out);
  const int B = (int)b, K = (int)k, V = (int)v_in, CI = (int)cin,
            CO = (int)cout, R = (int)num_out;
  if (!map_given) {
    spread_invert_kernel<<<dim3((unsigned)K, (unsigned)B), kInvertThreads, 0,
                           s>>>(static_cast<const int*>(targets), map, V, R);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (!x_bf16) {
    if (CO <= 16) return launch_fma<2>(x, w, map, o, B, K, V, CI, CO, R, s);
    if (CO <= 32) return launch_fma<4>(x, w, map, o, B, K, V, CI, CO, R, s);
    if (CO <= 64) return launch_fma<8>(x, w, map, o, B, K, V, CI, CO, R, s);
    return launch_fma<16>(x, w, map, o, B, K, V, CI, CO, R, s);
  }
  const int x_vec = CI % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int w_vec = CO % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (CI <= 16)
    return launch_mma_cout<1>(x, w, map, o, B, K, V, CI, CO, R, x_vec,
                              w_vec, s);
  if (CI <= 32)
    return launch_mma_cout<2>(x, w, map, o, B, K, V, CI, CO, R, x_vec,
                              w_vec, s);
  if (CI <= 64)
    return launch_mma_cout<4>(x, w, map, o, B, K, V, CI, CO, R, x_vec,
                              w_vec, s);
  return launch_mma_cout<8>(x, w, map, o, B, K, V, CI, CO, R, x_vec, w_vec,
                            s);
}
