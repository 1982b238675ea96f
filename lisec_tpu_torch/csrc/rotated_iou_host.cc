// The NMS kernel's pair IoU (rotated_iou.cuh) built for the host, so that
// the CPU tests can hold it against ops/rotated_iou.py::rotated_iou_bev.
// Built by g++ without floating-point contraction (ops/cuda/build.py).

#include "rotated_iou.cuh"

// out[i] = IoU(a[i], b[i]) for n pairs of 7-float boxes.
extern "C" int lisec_rotated_iou_pairs(const float* a, const float* b,
                                       long long n, float* out) {
  for (long long i = 0; i < n; ++i)
    out[i] = lisec_iou::pair_iou(a + 7 * i, b + 7 * i);
  return 0;
}
