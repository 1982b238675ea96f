"""Per-cloud augmentation for classification and segmentation (copy of
``_rot_z`` and ``augment_cloud`` from ``lisec_tpu/data/augment.py``).
Host-side numpy: rotate about the up axis, anisotropic scale, jitter
(sigma 0.01, clip 0.05), random point dropout. The detection
augmentation (GT sampling, per-box noise, global transforms) is not
ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _rot_z(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


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
