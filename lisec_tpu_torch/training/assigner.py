"""Anchor generation (copy of ``AnchorConfig``, ``DEFAULT_ANCHORS``,
``ROTATIONS`` and ``generate_anchors`` from
``lisec_tpu/training/assigner.py``; target assignment waits for the
training slice).

Anchors: one size per class (e.g. car (3.9, 1.6, 1.56)), two yaws
(0, pi/2), laid on the BEV output grid.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np


class AnchorConfig(NamedTuple):
    """Per-class anchor spec."""

    size: Tuple[float, float, float]      # (l, w, h)
    z_center: float
    pos_threshold: float
    neg_threshold: float


DEFAULT_ANCHORS = {
    "Car": AnchorConfig((3.9, 1.6, 1.56), -1.0, 0.6, 0.45),
    "Pedestrian": AnchorConfig((0.8, 0.6, 1.73), -0.6, 0.5, 0.35),
    "Cyclist": AnchorConfig((1.76, 0.6, 1.73), -0.6, 0.5, 0.35),
}

ROTATIONS = (0.0, np.pi / 2)


def generate_anchors(
    anchor_cfgs: Sequence[AnchorConfig],
    *,
    pc_range: Tuple[float, ...],
    feature_map_size: Tuple[int, int],     # (ny_out, nx_out)
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Dense anchor grid matching the head's (y, x, class, rot) layout.

    Returns (anchors (A, 7) f32, anchor_classes (A,) i32,
    pos_thr (A,), neg_thr (A,)) as host numpy (baked into the jitted
    program as constants).
    """
    ny, nx = feature_map_size
    xs = np.linspace(pc_range[0], pc_range[3], nx, endpoint=False) \
        + (pc_range[3] - pc_range[0]) / nx / 2
    ys = np.linspace(pc_range[1], pc_range[4], ny, endpoint=False) \
        + (pc_range[4] - pc_range[1]) / ny / 2

    anchors, classes, pos_t, neg_t = [], [], [], []
    for y in ys:
        for x in xs:
            for ci, cfg in enumerate(anchor_cfgs):
                for rot in ROTATIONS:
                    l, w, h = cfg.size
                    anchors.append([x, y, cfg.z_center, l, w, h, rot])
                    classes.append(ci)
                    pos_t.append(cfg.pos_threshold)
                    neg_t.append(cfg.neg_threshold)
    return (np.asarray(anchors, np.float32),
            np.asarray(classes, np.int32),
            np.asarray(pos_t, np.float32),
            np.asarray(neg_t, np.float32))
