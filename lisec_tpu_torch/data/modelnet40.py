"""Cloud normalisation (copy of ``normalize_cloud`` from
``lisec_tpu/data/modelnet40.py``; the ModelNet40 dataset itself comes with
the classification workload)."""

from __future__ import annotations

import numpy as np


def normalize_cloud(points: np.ndarray) -> np.ndarray:
    """Center to the centroid and scale into the unit sphere."""
    centered = points - points.mean(0, keepdims=True)
    scale = np.max(np.linalg.norm(centered, axis=1))
    return centered / max(scale, 1e-6)
