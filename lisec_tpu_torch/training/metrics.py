"""Evaluation metrics (copy of ``lisec_tpu/training/metrics.py``):
accuracy and class-mean accuracy (classification), class and instance
mIoU (part and range segmentation). KITTI AP lives in
``lisec_tpu_torch.eval.kitti_ap``. Accumulators are plain numpy on the
host, fed from device outputs moved once a batch.
"""

from __future__ import annotations

import numpy as np


class AccuracyMeter:
    def __init__(self, num_classes: int):
        self.correct = np.zeros(num_classes, np.int64)
        self.total = np.zeros(num_classes, np.int64)

    def update(self, pred: np.ndarray, label: np.ndarray) -> None:
        for c in np.unique(label):
            m = label == c
            self.correct[c] += int((pred[m] == c).sum())
            self.total[c] += int(m.sum())

    def overall(self) -> float:
        return float(self.correct.sum() / max(self.total.sum(), 1))

    def class_mean(self) -> float:
        seen = self.total > 0
        if not seen.any():
            return 0.0
        return float(np.mean(self.correct[seen] / self.total[seen]))


class IoUMeter:
    """Per-class intersection/union accumulator -> mIoU."""

    def __init__(self, num_classes: int, ignore: int = -1):
        self.num_classes = num_classes
        self.ignore = ignore
        self.inter = np.zeros(num_classes, np.int64)
        self.union = np.zeros(num_classes, np.int64)

    def update(self, pred: np.ndarray, label: np.ndarray) -> None:
        valid = label != self.ignore
        pred, label = pred[valid], label[valid]
        for c in range(self.num_classes):
            p = pred == c
            l = label == c
            self.inter[c] += int((p & l).sum())
            self.union[c] += int((p | l).sum())

    def miou(self, skip_class_0: bool = False) -> float:
        start = 1 if skip_class_0 else 0
        seen = self.union[start:] > 0
        if not seen.any():
            return 0.0
        iou = self.inter[start:][seen] / self.union[start:][seen]
        return float(np.mean(iou))

    def per_class(self) -> np.ndarray:
        return self.inter / np.maximum(self.union, 1)


def instance_miou(pred: np.ndarray, label: np.ndarray,
                  parts_of_category) -> float:
    """ShapeNetPart instance-average mIoU: per shape, mean IoU over the
    parts belonging to the shape's category, then mean over shapes.

    pred/label: (B, N); parts_of_category: callable cat_id -> part ids.
    """
    ious = []
    for p, l, parts in zip(pred, label, parts_of_category):
        shape_ious = []
        for part in parts:
            pm = p == part
            lm = l == part
            union = (pm | lm).sum()
            if union == 0:
                shape_ious.append(1.0)
            else:
                shape_ious.append(float((pm & lm).sum() / union))
        ious.append(np.mean(shape_ious))
    return float(np.mean(ious))
