"""Fixed-shape batching (port of ``pad_points`` from
``lisec_tpu/data/collate.py``, in plain numpy).

Every cloud is padded to the config's ``max_points`` so batch shapes are
static; overflowing points are dropped deterministically (lowest indices
kept).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def pad_points(cloud: np.ndarray, max_points: int) -> Dict[str, np.ndarray]:
    """Pad/truncate one (N, C) cloud to (max_points, C) + bool mask."""
    cloud = np.ascontiguousarray(cloud, np.float32)
    n = min(len(cloud), max_points)
    points = np.zeros((max_points, cloud.shape[1]), np.float32)
    points[:n] = cloud[:n]
    mask = np.zeros(max_points, bool)
    mask[:n] = True
    return {"points": points, "point_mask": mask}
