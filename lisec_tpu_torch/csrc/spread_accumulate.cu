// Spread-accumulate for Hopper: K row streams summed into one dense table.
//
// Replaces lisec_tpu/ops/pallas/spread_kernel.py::spread_accumulate (body
// _spread_kernel). The wrapper, its bound and the design notes are in
// lisec_tpu_torch/ops/cuda/spread_accumulate.py.
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
