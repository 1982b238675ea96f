"""Per-cloud augmentation (copy of ``lisec_tpu/data/augment.py``).
Host-side numpy.

Cls/seg: rotate about the up axis, anisotropic scale, jitter (sigma
0.01, clip 0.05), random point dropout. Detection: GT sampling (paste
boxes and their points from a ground-truth database built over the
train split), per-box noise (rotation and translation), global flip,
rotate and scale: the SECOND / PointPillars recipe. Every draw from the
generator comes in the JAX package's order, and the geometry goes
through ``lisec_tpu_torch.native``, which rounds as the JAX package's
C++ library does, so the augmented stream is that package's bit for
bit.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from lisec_tpu_torch import native


def _rot_z(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _points_in_box_np(points: np.ndarray, box: np.ndarray) -> np.ndarray:
    d = points[:, :3] - box[:3]
    c, s = np.cos(box[6]), np.sin(box[6])
    lx = d[:, 0] * c + d[:, 1] * s
    ly = -d[:, 0] * s + d[:, 1] * c
    return ((np.abs(lx) <= box[3] / 2) & (np.abs(ly) <= box[4] / 2)
            & (np.abs(d[:, 2]) <= box[5] / 2))


def augment_cloud(sample: Dict, rng: np.random.Generator, aug) -> Dict:
    """Cls/seg augmentation. Mutates a copy of `sample`."""
    if not aug.enabled:
        return sample
    pts = sample["points"].copy()
    if aug.rotate_z:
        pts[:, :3] = pts[:, :3] @ _rot_z(rng.uniform(0, 2 * np.pi)).T
    lo, hi = aug.scale_range
    if hi > lo:
        pts[:, :3] *= rng.uniform(lo, hi)
    if aug.jitter_sigma > 0:
        noise = np.clip(rng.normal(0, aug.jitter_sigma, pts[:, :3].shape),
                        -aug.jitter_clip, aug.jitter_clip)
        pts[:, :3] += noise.astype(pts.dtype)
    out = dict(sample)
    if aug.dropout_max > 0:
        keep = rng.uniform(size=len(pts)) > rng.uniform(0, aug.dropout_max)
        if keep.sum() >= 1:
            # Canonical "random dropout" replaces dropped points with the
            # first point so shapes stay fixed.
            pts[~keep] = pts[np.argmax(keep)]
            if "point_labels" in out:
                labels = out["point_labels"].copy()
                labels[~keep] = labels[np.argmax(keep)]
                out["point_labels"] = labels
    out["points"] = pts
    return out


class GTSampler:
    """GT-sampling database: crops of gt boxes + their points, pasted
    into other scenes to densify rare classes (SECOND's trick)."""

    def __init__(self, dataset, max_db_per_class: int = 256):
        self.db: Dict[int, List] = {}
        for i in range(len(dataset)):
            s = dataset[i]
            for box, cls in zip(s.get("gt_boxes", []),
                                s.get("gt_classes", [])):
                cls = int(cls)
                if len(self.db.get(cls, [])) >= max_db_per_class:
                    continue
                m = _points_in_box_np(s["points"], box)
                if m.sum() < 5:
                    continue
                self.db.setdefault(cls, []).append(
                    (box.copy(), s["points"][m].copy()))

    def sample(self, scene: Dict, rng: np.random.Generator,
               max_per_class: int = 15) -> Dict:
        boxes = list(scene["gt_boxes"])
        classes = list(scene["gt_classes"])
        new_pts = [scene["points"]]
        for cls, entries in self.db.items():
            want = max_per_class - sum(int(c) == cls for c in classes)
            for _ in range(max(want, 0)):
                box, pts = entries[int(rng.integers(len(entries)))]
                # Reject overlaps with existing boxes (BEV center dist).
                if boxes and np.min(
                        np.linalg.norm(
                            np.asarray(boxes)[:, :2] - box[:2], axis=1)
                ) < np.hypot(box[3], box[4]):
                    continue
                boxes.append(box)
                classes.append(cls)
                new_pts.append(pts)
        out = dict(scene)
        out["points"] = np.concatenate(new_pts)
        out["gt_boxes"] = (np.asarray(boxes, np.float32)
                           if boxes else np.zeros((0, 7), np.float32))
        out["gt_classes"] = np.asarray(classes, np.int32)
        return out


def augment_detection(sample: Dict, rng: np.random.Generator, aug,
                      gt_sampler: GTSampler | None = None) -> Dict:
    """Detection augmentation: GT-sampling, per-box noise, global
    flip/rotate/scale/translate — boxes and points stay consistent."""
    if not aug.enabled:
        return sample
    out = dict(sample)
    if aug.gt_sampling and gt_sampler is not None:
        out = gt_sampler.sample(out, rng, aug.gt_sample_max_per_class)
    pts = out["points"].copy()
    boxes = out["gt_boxes"].copy()

    # Per-box noise: rotate/translate each gt box and its points
    # (native kernel: one membership pass + one perturb pass).
    if (aug.box_noise_rot > 0 or aug.box_noise_trans > 0) and len(boxes):
        member = native.points_in_rbbox_first(pts, boxes)
        dyaw = rng.uniform(-aug.box_noise_rot, aug.box_noise_rot,
                           len(boxes)).astype(np.float32)
        dtrans = rng.normal(0, aug.box_noise_trans,
                            (len(boxes), 3)).astype(np.float32)
        native.perturb_boxes(pts, member, boxes[:, :3].copy(), dyaw,
                             dtrans)
        boxes[:, :3] += dtrans
        boxes[:, 6] += dyaw

    # Global flip over y (x stays, y negates, yaw negates).
    if aug.global_flip_y and rng.uniform() < 0.5:
        native.flip_y(pts)
        if len(boxes):
            boxes[:, 1] = -boxes[:, 1]
            boxes[:, 6] = -boxes[:, 6]

    # Global rotate/scale/translate as ONE fused native transform.
    yaw = rng.uniform(-aug.global_rotate, aug.global_rotate) \
        if aug.global_rotate > 0 else 0.0
    lo, hi = aug.scale_range
    s = rng.uniform(lo, hi) if hi > lo else 1.0
    t = rng.normal(0, aug.global_translate_std, 3).astype(np.float32) \
        if aug.global_translate_std > 0 else np.zeros(3, np.float32)
    if yaw != 0.0 or s != 1.0 or t.any():
        rot = _rot_z(yaw)
        native.transform_cloud(pts, rot, s, t)
        if len(boxes):
            boxes[:, :3] = boxes[:, :3] @ rot.T * s + t
            boxes[:, 3:6] *= s
            boxes[:, 6] += yaw

    if len(boxes):
        boxes[:, 6] = (boxes[:, 6] + np.pi) % (2 * np.pi) - np.pi
    out["points"] = pts
    out["gt_boxes"] = boxes
    return out
