"""The scene pool a run draws its requests from."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from portbench.harness.spec import load_module


def make_pool(cfg: Dict, scenes: str, pool: int, seed: int, root: Path
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(points (P, N, 4) f32, counts (P,) int) of ``pool`` scenes of the
    generator ``portbench/traffic/<scenes>.py`` for ``seed``, each cut to
    the configuration's ``max_points``."""
    n = int(cfg["budget"]["max_points"])
    seeds = np.random.SeedSequence(int(seed)).generate_state(int(pool))
    make = load_module("traffic", scenes, root).make_scene
    pts = np.zeros((len(seeds), n, 4), np.float32)
    counts = np.zeros((len(seeds),), np.int64)
    r = tuple(cfg["voxel"]["point_cloud_range"])
    for i, s in enumerate(seeds):
        p = make(int(s), pc_range=r)["points"][:n]
        pts[i, :len(p)] = p
        counts[i] = len(p)
    return pts, counts
