// Segment unpaint for Hopper: the row gather from a dense per-cell table,
// and the two callers' work fused into it.
//
// Replaces lisec_tpu/ops/pallas/unpaint.py::segment_unpaint (body
// _unpaint_kernel). The wrappers, their bounds and the design notes are in
// lisec_tpu_torch/ops/cuda/segment_unpaint.py. Three entry points, one
// launch each:
//
// Gather, table (B, R, C) f32, cell (B, N) int32, out (B, N, C) f32 or
// bf16:
//
//   out[b, i, :] = table[b, cell[b, i], :]   if 0 <= cell[b, i] < R
//                  0                         otherwise
//
// Segment-max backward, h (B, N, C) f32 or bf16, cell (B, N), canvas and
// g (B, R, C) f32, dh (B, N, C) in h's type:
//
//   dh[b, i, ch] = g[b, id, ch]  if id = cell[b, i] is in [0, R) and
//                                float(h[b, i, ch]) == canvas[b, id, ch]
//                  0             otherwise
//
// Pillar decoration, pts (B, N, 4) f32, cell (B, N) int32 sorted by cell,
// stats (B, NC, 4) f32 (a cell's xyz sums and count), feats (B, N, 9) f32:
//
//   [x, y, z, r, xyz - sums / max(count, 1), x - px, y - py] * (id < NC)
//
// with (px, py) the centre of cell min(id, NC - 1), column id mod nx and
// row id div nx (floor division, as torch's % and // on int tensors).
// Every operation rounds as the plain version's separate f32 ops do: the
// intrinsics below are never contracted into a fused multiply-add.
//
// Gather and backward move a row with a group of L lanes, L a power of
// two from 1 to 32: a unit is V channels (4 where C and the pointers
// allow, a 16-byte load of the table), lane j moves units j, j + L, ...
// of the row, so a warp's loads and stores of one row are contiguous. The
// group's first lane loads the row's id once and hands it to the others
// by a shuffle; each lane computes the row's 64-bit bases once and moves
// its units with 32-bit offsets from them. A group keeps two rows in
// flight (all their loads issued before the stores). A block's rows are
// one cloud's (blockIdx.y, blockIdx.z), so no index is divided. Every
// output element is written once, the zero rows of invalid ids included;
// no atomics, nothing patched afterwards.
//
// The decoration is one thread a point, two points in flight: ids and
// points first, then the points' stats rows. The 9-float output rows are
// staged in shared memory and written by the block as one coalesced run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 2;                      // rows in flight a group
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFeat = 9;                      // decoration channels

template <int V>
struct Unit {
  float f[V];
};

template <int V>
__device__ __forceinline__ Unit<V> zero_unit() {
  Unit<V> u;
#pragma unroll
  for (int e = 0; e < V; ++e) u.f[e] = 0.0f;
  return u;
}

template <int V>
__device__ __forceinline__ Unit<V> load(const float* p) {
  Unit<V> u;
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    u.f[0] = t.x;
    u.f[1] = t.y;
    u.f[2] = t.z;
    u.f[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    u.f[0] = t.x;
    u.f[1] = t.y;
  } else {
    u.f[0] = __ldg(p);
  }
  return u;
}

// bf16 is carried as its 16 bits; widening to f32 is exact.
__device__ __forceinline__ float bf16_to_f32(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

template <int V>
__device__ __forceinline__ Unit<V> load(const uint16_t* p) {
  Unit<V> u;
  if constexpr (V == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    u.f[0] = bf16_to_f32(t.x & 0xffffu);
    u.f[1] = bf16_to_f32(t.x >> 16);
    u.f[2] = bf16_to_f32(t.y & 0xffffu);
    u.f[3] = bf16_to_f32(t.y >> 16);
  } else if constexpr (V == 2) {
    const uint32_t t = __ldg(reinterpret_cast<const unsigned int*>(p));
    u.f[0] = bf16_to_f32(t & 0xffffu);
    u.f[1] = bf16_to_f32(t >> 16);
  } else {
    u.f[0] = bf16_to_f32(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
  return u;
}

// f32 to bf16 rounded to nearest even, as torch's Tensor.to does (a NaN
// becomes the quiet NaN 0x7fc0).
__device__ __forceinline__ uint32_t f32_to_bf16(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

// Output stores are streaming (evict-first): the output is written once
// and is far larger than L2, where the ids and the table rows should stay.
template <int V>
__device__ __forceinline__ void store(float* p, const Unit<V>& u) {
  if constexpr (V == 4)
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(u.f[0], u.f[1], u.f[2], u.f[3]));
  else if constexpr (V == 2)
    __stcs(reinterpret_cast<float2*>(p), make_float2(u.f[0], u.f[1]));
  else
    __stcs(p, u.f[0]);
}

template <int V>
__device__ __forceinline__ void store(uint16_t* p, const Unit<V>& u) {
  if constexpr (V == 4)
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(f32_to_bf16(u.f[0]) | f32_to_bf16(u.f[1]) << 16,
                      f32_to_bf16(u.f[2]) | f32_to_bf16(u.f[3]) << 16));
  else if constexpr (V == 2)
    __stcs(reinterpret_cast<unsigned int*>(p),
           f32_to_bf16(u.f[0]) | f32_to_bf16(u.f[1]) << 16);
  else
    __stcs(reinterpret_cast<unsigned short*>(p),
           (unsigned short)f32_to_bf16(u.f[0]));
}

// A block's cloud: the grid is (tiles, min(B, 65535), ceil(B / 65535)).
__device__ __forceinline__ int block_cloud() {
  return (int)(blockIdx.z * 65535u + blockIdx.y);
}

// The table row of row i of this cloud (-1 for an id outside [0, r) or
// a row past the cloud's end), loaded by the group's first lane and shared
// with the group's L lanes; every lane of the warp takes part.
__device__ __forceinline__ int table_row(const int* __restrict__ ids, int i,
                                         int n, int r, int j, int lanes) {
  int id = -1;
  if (j == 0 && i < n) {
    const int v = __ldg(ids + i);
    if (v >= 0 && v < r) id = v;
  }
  return lanes > 1 ? __shfl_sync(kFull, id, 0, lanes) : id;
}

// Gather. Out: float, or uint16_t for bf16 bits. A block holds
// kThreads >> lshift groups of 1 << lshift lanes and moves kRows * groups
// consecutive rows of one cloud.
template <int V, typename Out>
__global__ void __launch_bounds__(kThreads)
unpaint_kernel(const float* __restrict__ table,  // (B, R, C)
               const int* __restrict__ cell,     // (B, N)
               Out* __restrict__ out,            // (B, N, C)
               int nb, int n, int r, int c, int lshift) {
  const int b = block_cloud();
  if (b >= nb) return;
  const int lanes = 1 << lshift;
  const int groups = kThreads >> lshift;
  const int j = threadIdx.x & (lanes - 1);
  const int first = blockIdx.x * kRows * groups + (threadIdx.x >> lshift);
  const int units = c / V;
  const int* ids = cell + (size_t)b * n;
  const float* src[kRows];
  Out* dst[kRows];
  bool live[kRows], hit[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = first + k * groups;
    const int id = table_row(ids, i, n, r, j, lanes);
    live[k] = i < n;
    hit[k] = id >= 0;
    src[k] = table + ((size_t)b * r + (hit[k] ? id : 0)) * c;
    dst[k] = out + ((size_t)b * n + (live[k] ? i : 0)) * c;
  }
  for (int u = j; u < units; u += lanes) {
    Unit<V> v[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      v[k] = hit[k] ? load<V>(src[k] + u * V) : zero_unit<V>();
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (live[k]) store<V>(dst[k] + u * V, v[k]);
  }
}

// Segment-max backward, in the gather's tiles. H: float, or uint16_t for
// bf16 bits (h's type, and dh's).
template <int V, typename H>
__global__ void __launch_bounds__(kThreads)
segmax_backward_kernel(const H* __restrict__ h,           // (B, N, C)
                       const int* __restrict__ cell,      // (B, N)
                       const float* __restrict__ canvas,  // (B, R, C)
                       const float* __restrict__ g,       // (B, R, C)
                       H* __restrict__ dh,                // (B, N, C)
                       int nb, int n, int r, int c, int lshift) {
  const int b = block_cloud();
  if (b >= nb) return;
  const int lanes = 1 << lshift;
  const int groups = kThreads >> lshift;
  const int j = threadIdx.x & (lanes - 1);
  const int first = blockIdx.x * kRows * groups + (threadIdx.x >> lshift);
  const int units = c / V;
  const int* ids = cell + (size_t)b * n;
  size_t tab[kRows], row[kRows];
  bool live[kRows], hit[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = first + k * groups;
    const int id = table_row(ids, i, n, r, j, lanes);
    live[k] = i < n;
    hit[k] = id >= 0;
    tab[k] = ((size_t)b * r + (hit[k] ? id : 0)) * c;
    row[k] = ((size_t)b * n + (live[k] ? i : 0)) * c;
  }
  for (int u = j; u < units; u += lanes) {
    Unit<V> mx[kRows], gv[kRows], hv[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (hit[k]) {
        mx[k] = load<V>(canvas + tab[k] + u * V);
        gv[k] = load<V>(g + tab[k] + u * V);
        hv[k] = load<V>(h + row[k] + u * V);
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      Unit<V> d = zero_unit<V>();
      if (hit[k]) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          d.f[e] = hv[k].f[e] == mx[k].f[e] ? gv[k].f[e] : 0.0f;
      }
      if (live[k]) store<V>(dh + row[k] + u * V, d);
    }
  }
}

// floor(a / m) and a - m floor(a / m) for m > 0, as torch's // and %.
__device__ __forceinline__ void floor_divmod(int a, int m, int& q, int& rem) {
  q = a / m;
  rem = a - q * m;
  if (rem < 0) {
    rem += m;
    q -= 1;
  }
}

// Decoration: a block moves kRows * kThreads points of one cloud, thread
// t points t and t + kThreads of the tile.
__global__ void __launch_bounds__(kThreads)
decorate_kernel(const float4* __restrict__ pts,    // (B, N) x 4
                const int* __restrict__ cell,      // (B, N)
                const float4* __restrict__ stats,  // (B, NC) x 4
                float* __restrict__ feats,         // (B, N, 9)
                int nb, int n, int ncells, int nx, float vx, float vy,
                float x0, float y0) {
  __shared__ float tile[kRows * kThreads * kFeat];
  const int b = block_cloud();
  if (b >= nb) return;
  const int first = blockIdx.x * kRows * kThreads;
  const size_t base = (size_t)b * n + first;
  int id[kRows];
  float4 p[kRows], s[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = first + k * kThreads + threadIdx.x;
    id[k] = i < n ? __ldg(cell + base + k * kThreads + threadIdx.x) : ncells;
    p[k] = i < n ? __ldg(pts + base + k * kThreads + threadIdx.x)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k)
    s[k] = id[k] >= 0 && id[k] < ncells
               ? __ldg(stats + (size_t)b * ncells + id[k])
               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const float ones = id[k] < ncells ? 1.0f : 0.0f;
    const float cnt = s[k].w < 1.0f ? 1.0f : s[k].w;   // clamp_min(1.0)
    int qy, qx;
    floor_divmod(id[k] < ncells ? id[k] : ncells - 1, nx, qy, qx);
    const float px =
        __fadd_rn(__fmul_rn(__fadd_rn(__int2float_rn(qx), 0.5f), vx), x0);
    const float py =
        __fadd_rn(__fmul_rn(__fadd_rn(__int2float_rn(qy), 0.5f), vy), y0);
    const float f[kFeat] = {
        p[k].x, p[k].y, p[k].z, p[k].w,
        __fsub_rn(p[k].x, __fdiv_rn(s[k].x, cnt)),
        __fsub_rn(p[k].y, __fdiv_rn(s[k].y, cnt)),
        __fsub_rn(p[k].z, __fdiv_rn(s[k].z, cnt)),
        __fsub_rn(p[k].x, px), __fsub_rn(p[k].y, py)};
    float* t = tile + (k * kThreads + threadIdx.x) * kFeat;
#pragma unroll
    for (int e = 0; e < kFeat; ++e) t[e] = __fmul_rn(f[e], ones);
  }
  __syncthreads();
  const int rows = min(kRows * kThreads, n - first);
  float* o = feats + base * kFeat;
  for (int e = threadIdx.x; e < rows * kFeat; e += kThreads) o[e] = tile[e];
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Lanes a row of `units` units takes, as log2: the power of two at or
// above it, at most 32.
int lane_shift(int units) {
  int shift = 0;
  while (shift < 5 && (1 << shift) < units) ++shift;
  return shift;
}

dim3 cloud_grid(int b, int n, int rows_per_block) {
  return dim3((unsigned)((n + rows_per_block - 1) / rows_per_block),
              (unsigned)(b < 65535 ? b : 65535),
              (unsigned)((b + 65534) / 65535));
}

template <int V, typename Out>
int launch_unpaint(const void* table, const void* cell, void* out, int b,
                   int n, int r, int c, cudaStream_t s) {
  const int shift = lane_shift(c / V);
  unpaint_kernel<V, Out><<<cloud_grid(b, n, kRows * (kThreads >> shift)),
                           kThreads, 0, s>>>(
      static_cast<const float*>(table), static_cast<const int*>(cell),
      static_cast<Out*>(out), b, n, r, c, shift);
  return (int)cudaGetLastError();
}

template <int V, typename H>
int launch_segmax_backward(const void* h, const void* cell,
                           const void* canvas, const void* g, void* dh,
                           int b, int n, int r, int c, cudaStream_t s) {
  const int shift = lane_shift(c / V);
  segmax_backward_kernel<V, H>
      <<<cloud_grid(b, n, kRows * (kThreads >> shift)), kThreads, 0, s>>>(
          static_cast<const H*>(h), static_cast<const int*>(cell),
          static_cast<const float*>(canvas), static_cast<const float*>(g),
          static_cast<H*>(dh), b, n, r, c, shift);
  return (int)cudaGetLastError();
}

bool sizes_ok(long long b, long long n, long long r, long long c) {
  const long long most = 2147483647ll;
  return b >= 1 && n >= 1 && r >= 1 && c >= 1 && b <= 65535ll * 65535ll &&
         n <= most && r <= most && c <= most;
}

}  // namespace

// Plain C entry points (loaded with ctypes), every size one 64-bit word.
// Each returns the cudaError_t of its launch; 0 means it was accepted.

// out_bf16: 0 for an f32 output, 1 for bf16.
extern "C" int lisec_segment_unpaint(const void* table, const void* cell,
                                     void* out, long long b, long long n,
                                     long long r, long long c,
                                     long long out_bf16, void* stream) {
  if (!sizes_ok(b, n, r, c) || (out_bf16 != 0 && out_bf16 != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = (int)b, N = (int)n, R = (int)r, C = (int)c;
  const int out_bytes = out_bf16 ? 2 : 4;
  auto fits = [&](int v) {
    return C % v == 0 && aligned(table, 4 * v) && aligned(out, out_bytes * v);
  };
  if (out_bf16) {
    if (fits(4))
      return launch_unpaint<4, uint16_t>(table, cell, out, B, N, R, C, s);
    if (fits(2))
      return launch_unpaint<2, uint16_t>(table, cell, out, B, N, R, C, s);
    return launch_unpaint<1, uint16_t>(table, cell, out, B, N, R, C, s);
  }
  if (fits(4))
    return launch_unpaint<4, float>(table, cell, out, B, N, R, C, s);
  if (fits(2))
    return launch_unpaint<2, float>(table, cell, out, B, N, R, C, s);
  return launch_unpaint<1, float>(table, cell, out, B, N, R, C, s);
}

// h_bf16: 0 for f32 h and dh, 1 for bf16.
extern "C" int lisec_segment_max_backward(const void* h, const void* cell,
                                          const void* canvas, const void* g,
                                          void* dh, long long b, long long n,
                                          long long r, long long c,
                                          long long h_bf16, void* stream) {
  if (!sizes_ok(b, n, r, c) || (h_bf16 != 0 && h_bf16 != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = (int)b, N = (int)n, R = (int)r, C = (int)c;
  const int hb = h_bf16 ? 2 : 4;
  const bool v4 = C % 4 == 0 && aligned(canvas, 16) && aligned(g, 16) &&
                  aligned(h, 4 * hb) && aligned(dh, 4 * hb);
  if (h_bf16) {
    if (v4)
      return launch_segmax_backward<4, uint16_t>(h, cell, canvas, g, dh, B, N,
                                                 R, C, s);
    return launch_segmax_backward<1, uint16_t>(h, cell, canvas, g, dh, B, N,
                                               R, C, s);
  }
  if (v4)
    return launch_segmax_backward<4, float>(h, cell, canvas, g, dh, B, N, R,
                                            C, s);
  return launch_segmax_backward<1, float>(h, cell, canvas, g, dh, B, N, R, C,
                                          s);
}

// pts and stats 16-byte aligned (the wrapper's tensors are contiguous
// and freshly allocated or views at offset 0).
extern "C" int lisec_pillar_decorate(const void* pts, const void* cell,
                                     const void* stats, void* feats,
                                     long long b, long long n,
                                     long long ncells, long long nx,
                                     float vx, float vy, float x0, float y0,
                                     void* stream) {
  if (!sizes_ok(b, n, ncells, nx) || !aligned(pts, 16) ||
      !aligned(stats, 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  decorate_kernel<<<cloud_grid((int)b, (int)n, kRows * kThreads), kThreads,
                    0, s>>>(
      static_cast<const float4*>(pts), static_cast<const int*>(cell),
      static_cast<const float4*>(stats), static_cast<float*>(feats), (int)b,
      (int)n, (int)ncells, (int)nx, vx, vy, x0, y0);
  return (int)cudaGetLastError();
}
