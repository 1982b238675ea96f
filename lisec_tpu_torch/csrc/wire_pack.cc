// The int16 wire's pack (``lisec_tpu_torch/data/wire.py::pack_points_q16``)
// as host code: two passes over each cloud's valid rows in place of numpy's
// passes over the whole padded batch.
//
// The rows whose mask byte is set are visited in order, as runs of
// consecutive rows: once for the per-channel bounds, once more to write
// their codes to the cloud's row prefix (so a mask that is not a prefix is
// compacted stably on the way); the rows past the count take the padding
// code -32768.
//
// The arithmetic is numpy's, operation for operation, in f32 with the
// default rounding, built without -ffast-math and without contraction
// (-ffp-contract=off), so the codes, bounds and steps equal those of the
// numpy pack bit for bit:
//
//   lo, hi = min, max over the valid points (a NaN among them makes both
//            NaN, as numpy's min and max propagate it); no valid point at
//            all gives lo = 0, hi = 1
//   width  = max(hi - lo, 1e-6f)          (a NaN width stays NaN)
//   scale  = width / 65535                (a true division)
//   code   = clip(rint((p - lo) / scale) - 32768, -32768, 32767)
//
// rint rounds half to even. A NaN code becomes 0, what numpy's cast of a
// NaN to int16 gives on x86-64 and aarch64. A minimum and a maximum do not
// depend on the order in which the points are visited.
//
// Both passes work on chunks of kRows rows read as one flat run of floats,
// each float against the bound of its own lane (lane t holds channel
// t % c), so that the compiler vectorizes them for any channel count.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr float kLevels = 65535.0f;
constexpr float kMinWidth = 1e-6f;
constexpr float kOffset = 32768.0f;
constexpr float kTwo23 = 8388608.0f;
constexpr int16_t kPad = -32768;
constexpr int64_t kRows = 16;

// The next run of set mask bytes at or after row ``j`` of ``mask[0, n)``:
// its first row in ``*start`` and the row past its last as the result
// (``*start == n`` when there is none).
inline int64_t next_run(const uint8_t* mask, int64_t n, int64_t j,
                        int64_t* start) {
  while (j < n && mask[j] == 0) ++j;
  *start = j;
  if (j == n) return n;
  const void* zero = std::memchr(mask + j, 0, static_cast<size_t>(n - j));
  return zero ? static_cast<const uint8_t*>(zero) - mask : n;
}

// ``p - lo`` is at least 0 and at most ``width``, since ``lo`` and ``hi``
// bound the valid points, so ``x = (p - lo) / scale`` lies in [0, 65536)
// unless it is NaN. On [0, 2^23) adding 2^23 rounds the fraction away half
// to even (the sum's ulp is 1) and subtracting it again is exact: that is
// rint. A NaN stays NaN.
inline int16_t code_of(float p, float lo, float scale) {
  const float x = (p - lo) / scale;
  float q = ((x + kTwo23) - kTwo23) - kOffset;
  q = q < -32768.0f ? -32768.0f : q;
  q = q > 32767.0f ? 32767.0f : q;
  q = q == q ? q : 0.0f;
  return static_cast<int16_t>(static_cast<int32_t>(q));
}

}  // namespace

extern "C" {

// points (b, n, c) f32 and mask (b, n) bytes (0 or 1), both C-contiguous;
// writes codes (b, n, c) int16, counts (b,) int32, lo (c,) f32 and
// scale (c,) f32.
void lisec_wire_pack_q16(const float* points, const uint8_t* mask,
                         int64_t b, int64_t n, int64_t c, int16_t* codes,
                         int32_t* counts, float* lo, float* scale) {
  const float inf = std::numeric_limits<float>::infinity();
  const int64_t lanes = kRows * c;
  // Per lane: the least and greatest value seen, and 1 where a NaN was.
  std::vector<float> lane_lo(lanes, inf), lane_hi(lanes, -inf);
  std::vector<float> lane_nan(lanes, 0.0f);
  float* llo = lane_lo.data();
  float* lhi = lane_hi.data();
  float* lnan = lane_nan.data();
  bool any = false;
  for (int64_t i = 0; i < b; ++i) {
    const uint8_t* m = mask + i * n;
    const float* pts = points + i * n * c;
    int64_t count = 0, s = 0;
    for (int64_t e = next_run(m, n, 0, &s); s < n;
         e = next_run(m, n, e, &s)) {
      const float* end = pts + e * c;
      for (const float* p = pts + s * c; p < end; p += lanes) {
        const int64_t len = std::min<int64_t>(lanes, end - p);
        for (int64_t t = 0; t < len; ++t) {
          const float v = p[t];
          llo[t] = v < llo[t] ? v : llo[t];
          lhi[t] = v > lhi[t] ? v : lhi[t];
          lnan[t] = v != v ? 1.0f : lnan[t];
        }
      }
      count += e - s;
    }
    counts[i] = static_cast<int32_t>(count);
    any |= count > 0;
  }

  // The bounds, and the lanes' copies of ``lo`` and ``scale``.
  std::vector<float> lane_off(lanes), lane_scale(lanes);
  for (int64_t k = 0; k < c; ++k) {
    float l = 0.0f, h = 1.0f;
    if (any) {
      l = inf;
      h = -inf;
      bool nan = false;
      for (int64_t t = k; t < lanes; t += c) {
        l = llo[t] < l ? llo[t] : l;
        h = lhi[t] > h ? lhi[t] : h;
        nan |= lnan[t] != 0.0f;
      }
      if (nan) l = h = std::numeric_limits<float>::quiet_NaN();
    }
    float w = h - l;
    w = w < kMinWidth ? kMinWidth : w;
    lo[k] = l;
    scale[k] = w / kLevels;
    for (int64_t t = k; t < lanes; t += c) {
      lane_off[t] = lo[k];
      lane_scale[t] = scale[k];
    }
  }
  const float* loff = lane_off.data();
  const float* lscale = lane_scale.data();

  for (int64_t i = 0; i < b; ++i) {
    const uint8_t* m = mask + i * n;
    const float* pts = points + i * n * c;
    int16_t* out = codes + i * n * c;
    int64_t s = 0;
    for (int64_t e = next_run(m, n, 0, &s); s < n;
         e = next_run(m, n, e, &s)) {
      const float* end = pts + e * c;
      for (const float* p = pts + s * c; p < end; p += lanes) {
        const int64_t len = std::min<int64_t>(lanes, end - p);
        for (int64_t t = 0; t < len; ++t) {
          out[t] = code_of(p[t], loff[t], lscale[t]);
        }
        out += len;
      }
    }
    std::fill(out, codes + (i + 1) * n * c, kPad);
  }
}

}  // extern "C"
