// Rotated BEV IoU of one pair of boxes, for the device and the host.
//
// The same function as lisec_tpu_torch/ops/rotated_iou.py::rotated_iou_bev
// on one pair, in its f32 operations and their order: the pair recentred
// at the midpoint of its centres, the corners of
// ops/boxes.py::boxes_to_corners_bev, the 4 + 4 corner-inside tests, the
// 16 edge-pair intersections, the pseudo-angle key around the valid
// candidates' centroid, a stable sort of the keys, and the shoelace sum.
// Every product, sum and quotient rounds where the torch code rounds:
// build it with no floating-point contraction (nvcc -fmad=false, g++
// -ffp-contract=off), IEEE division and the library's cosf / sinf, and
// without fast-math.
//
// The three 24-wide sums, whose order torch leaves to its reduction:
//  * the valid count, an integer, is exact in any order;
//  * the centroid's x and y each sum the valid candidates' coordinates in
//    ascending candidate order (a's corners, b's corners, then the
//    intersections, edge of a major), starting from the first; torch's
//    product by the 0/1 mask adds zeros for the invalid ones, which
//    change no sum;
//  * the shoelace sum adds the ring's cross products in sorted order,
//    starting from the first.
// A sum of n terms in another order moves by at most about n ulps of its
// largest partial sum, so the IoU of the same pair may differ from
// torch's in its last bits: kIouSumOrderTol bounds that difference. The
// keep sets of NMS change only for a pair whose IoU lies that close to
// the threshold.
//
// Boxes are (x, y, z, l, w, h, yaw) and finite; only x, y, l, w and yaw
// are read.

#pragma once

#include <math.h>

#ifdef __CUDACC__
#define LISEC_HD __host__ __device__ __forceinline__
#else
#define LISEC_HD inline
#endif

namespace lisec_iou {

// The tolerance of the inside and intersection predicates, and the
// floor of the union and of the pseudo-angle's denominator, as torch
// compares an f32 tensor with the Python float: cast to f32.
constexpr float kEps = static_cast<float>(1e-5);
constexpr float kNegEps = static_cast<float>(-1e-5);
constexpr float kOneEps = static_cast<float>(1.0 + 1e-5);

// The largest difference of the IoU from rotated_iou_bev's that the sum
// order above allows (see the header).
constexpr float kIouSumOrderTol = 2e-6f;

// torch.minimum and clamp_min: a NaN on either side gives NaN.
LISEC_HD float nan_min(float a, float b) {
  return (a != a || b != b) ? (a + b) : (a < b ? a : b);
}

LISEC_HD float nan_max(float a, float b) {
  return (a != a || b != b) ? (a + b) : (a > b ? a : b);
}

// The ascending order of torch.sort: NaN after every number.
LISEC_HD bool sorts_after(float a, float b) {
  return a > b || (a != a && b == b);
}

// boxes_to_corners_bev: counter-clockwise from front-left in the box
// frame, cx = x + dx c - dy s and cy = y + dx s + dy c, left to right.
LISEC_HD void corners(float x, float y, float l, float w, float yaw,
                      float* cx, float* cy) {
  const float dx[4] = {l / 2.0f, -l / 2.0f, -l / 2.0f, l / 2.0f};
  const float dy[4] = {w / 2.0f, w / 2.0f, -w / 2.0f, -w / 2.0f};
  const float c = cosf(yaw);
  const float s = sinf(yaw);
  for (int k = 0; k < 4; ++k) {
    cx[k] = (x + dx[k] * c) - dy[k] * s;
    cy[k] = (y + dx[k] * s) + dy[k] * c;
  }
}

// _cross(o, a, b) = (a - o) x (b - o).
LISEC_HD float cross(float ox, float oy, float ax, float ay, float bx,
                     float by) {
  return (ax - ox) * (by - oy) - (ay - oy) * (bx - ox);
}

// _corners_inside: point p inside the CCW quad q, every edge's cross
// >= -eps.
LISEC_HD bool inside(float px, float py, const float* qx, const float* qy) {
  bool in = true;
  for (int e = 0; e < 4; ++e) {
    const int f = (e + 1) & 3;
    in = in && cross(qx[e], qy[e], qx[f], qy[f], px, py) >= kNegEps;
  }
  return in;
}

// _pseudo_angle: a key monotone in the angle, in [0, 4).
LISEC_HD float pseudo_angle(float dx, float dy) {
  const float r = dx / nan_max(fabsf(dx) + fabsf(dy), kEps);
  return dy >= 0.0f ? 1.0f - r : 3.0f + r;
}

// rotated_iou_bev of one pair: a and b point at 7 floats each.
LISEC_HD float pair_iou(const float* a, const float* b) {
  const float mx = 0.5f * (a[0] + b[0]);
  const float my = 0.5f * (a[1] + b[1]);
  float ax[4], ay[4], bx[4], by[4];
  corners(a[0] - mx, a[1] - my, a[3], a[4], a[6], ax, ay);
  corners(b[0] - mx, b[1] - my, b[3], b[4], b[6], bx, by);

  // The 24 candidates in torch's order, the valid ones compacted in it.
  float vx[24], vy[24];
  int k = 0;
  for (int p = 0; p < 4; ++p)
    if (inside(ax[p], ay[p], bx, by)) {
      vx[k] = ax[p];
      vy[k] = ay[p];
      ++k;
    }
  for (int p = 0; p < 4; ++p)
    if (inside(bx[p], by[p], ax, ay)) {
      vx[k] = bx[p];
      vy[k] = by[p];
      ++k;
    }
  for (int i = 0; i < 4; ++i) {
    const int i2 = (i + 1) & 3;
    const float d1x = ax[i2] - ax[i];
    const float d1y = ay[i2] - ay[i];
    for (int j = 0; j < 4; ++j) {
      const int j2 = (j + 1) & 3;
      const float d2x = bx[j2] - bx[j];
      const float d2y = by[j2] - by[j];
      const float denom = d1x * d2y - d1y * d2x;
      const float dqx = bx[j] - ax[i];
      const float dqy = by[j] - ay[i];
      const float t_num = dqx * d2y - dqy * d2x;
      const float u_num = dqx * d1y - dqy * d1x;
      const bool parallel = fabsf(denom) < kEps;
      const float safe = parallel ? 1.0f : denom;
      const float t = t_num / safe;
      const float u = u_num / safe;
      if (!parallel && t >= kNegEps && t <= kOneEps && u >= kNegEps &&
          u <= kOneEps) {
        vx[k] = ax[i] + t * d1x;
        vy[k] = ay[i] + t * d1y;
        ++k;
      }
    }
  }

  float inter = 0.0f;
  if (k >= 3) {
    // Centroid: ascending candidate order, from the first.
    float sx = vx[0], sy = vy[0];
    for (int p = 1; p < k; ++p) {
      sx += vx[p];
      sy += vy[p];
    }
    const float kf = static_cast<float>(k);
    const float gx = sx / kf;
    const float gy = sy / kf;
    // Stable insertion sort of the valid keys; invalid keys (1e9) would
    // sort after them all, so they are left out.
    float rx[24], ry[24], key[24];
    for (int p = 0; p < k; ++p) {
      const float qx = vx[p] - gx;
      const float qy = vy[p] - gy;
      const float kp = pseudo_angle(qx, qy);
      int q = p;
      while (q > 0 && sorts_after(key[q - 1], kp)) {
        key[q] = key[q - 1];
        rx[q] = rx[q - 1];
        ry[q] = ry[q - 1];
        --q;
      }
      key[q] = kp;
      rx[q] = qx;
      ry[q] = qy;
    }
    // Shoelace: the ring's cross products in sorted order, from the
    // first; the last wraps to the first.
    float sum = 0.0f;
    for (int p = 0; p < k; ++p) {
      const int n = p + 1 < k ? p + 1 : 0;
      const float c = rx[p] * ry[n] - ry[p] * rx[n];
      sum = p == 0 ? c : sum + c;
    }
    inter = 0.5f * fabsf(sum);
  }
  const float area_a = a[3] * a[4];
  const float area_b = b[3] * b[4];
  inter = nan_min(inter, nan_min(area_a, area_b));
  const float uni = area_a + area_b - inter;
  return inter / nan_max(uni, kEps);
}

}  // namespace lisec_iou

#undef LISEC_HD
