// Dropout masks of the reference's random stream: for a threefry key
// (k0, k1), a flat element offset and a count, element i of the output
// is 1 where flax's ``Dropout`` keeps it, i.e. where
// ``jax.random.bernoulli(key, keep, shape)`` is true at flat index
// offset + i:
//
//   (y0, y1) = threefry2x32((k0, k1), hi(offset + i), lo(offset + i))
//   u        = float((y0 ^ y1) >> 9 | 0x3f800000) - 1      in [0, 1)
//   out[i]   = u < keep
//
// Threefry-2x32 with 20 rounds and JAX's rotations and key schedule
// (jax/_src/prng.py, _threefry2x32_lowering). The stream is partitionable:
// each element depends only on its own flat index, so a rank of a data
// mesh draws its rows alone from the offset of its first one.
//
// No TPU kernel is replaced: the JAX package draws these bits in XLA
// under nn.Dropout (lisec_tpu/models/pointnet2.py:146, 174, 178 and
// lisec_tpu/models/common.py:52). One thread per element keeps the two
// words and the three key words in registers through the 20 rounds. It
// is bound by integer operations: 20 rounds of an add, a rotate (one
// funnel shift) and a xor, plus the key injections, about 85 integer
// operations an element, against one byte written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

#define ROUND(r)          \
  x0 += x1;               \
  x1 = rotl(x1, r) ^ x0;

__global__ void bernoulli_mask_kernel(uint32_t k0, uint32_t k1,
                                      unsigned long long offset,
                                      long long count, float keep,
                                      uint8_t* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const unsigned long long c = offset + (unsigned long long)i;
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = (uint32_t)(c >> 32) + k0;
  uint32_t x1 = (uint32_t)c + k1;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  ROUND(17) ROUND(29) ROUND(16) ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  ROUND(17) ROUND(29) ROUND(16) ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  const uint32_t bits = x0 ^ x1;
  // Exact: a float in [1, 2) less 1.
  const float u = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
  out[i] = u < keep ? 1 : 0;
}

#undef ROUND

}  // namespace

extern "C" int lisec_threefry_bernoulli(uint32_t k0, uint32_t k1,
                                        unsigned long long offset,
                                        long long count, float keep,
                                        void* out, void* stream) {
  if (count <= 0) return 0;
  const int threads = 256;
  const long long blocks = (count + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bernoulli_mask_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      k0, k1, offset, count, keep, (uint8_t*)out);
  return (int)cudaGetLastError();
}
