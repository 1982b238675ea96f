"""ModelNet40 dataset (copy of ``lisec_tpu/data/modelnet40.py``).

Real layout: modelnet40_normal_resampled — one directory per class with
comma-separated ``x,y,z,nx,ny,nz`` txt files plus ``shape_names.txt``
and train/test id lists. Clouds are cut (or tiled) to ``num_points`` and
unit-sphere normalized. ``fixture=True`` generates the deterministic
synthetic mini-dataset instead: seeds ``i`` for train, ``10_000 + i``
for test.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from lisec_tpu_torch.data.fixtures import make_cls_cloud
from lisec_tpu_torch.registry import register_dataset


def normalize_cloud(points: np.ndarray) -> np.ndarray:
    """Center to the centroid and scale into the unit sphere."""
    centered = points - points.mean(0, keepdims=True)
    scale = np.max(np.linalg.norm(centered, axis=1))
    return centered / max(scale, 1e-6)


@register_dataset("modelnet40")
class ModelNet40:
    def __init__(self, cfg, split: str = "train"):
        self.num_points = cfg.data.num_points
        self.num_classes = cfg.data.num_classes
        self.fixture = cfg.data.fixture
        self.split = split
        if self.fixture:
            self.size = cfg.data.fixture_size
            return
        root = cfg.data.root
        with open(os.path.join(root, "shape_names.txt")) as f:
            self.names = [line.strip() for line in f if line.strip()]
        with open(os.path.join(root, f"modelnet_{split}.txt")) as f:
            self.ids = [line.strip() for line in f if line.strip()]
        self.root = root
        self.size = len(self.ids)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if self.fixture:
            cls = i % self.num_classes
            seed = i if self.split == "train" else 10_000 + i
            pts = make_cls_cloud(seed, cls, self.num_points)
            return {"points": normalize_cloud(pts), "label": cls}
        sid = self.ids[i]
        name = "_".join(sid.split("_")[:-1])
        path = os.path.join(self.root, name, sid + ".txt")
        arr = np.loadtxt(path, delimiter=",", dtype=np.float32)
        pts = arr[: self.num_points, :3]
        if len(pts) < self.num_points:
            reps = -(-self.num_points // len(pts))
            pts = np.tile(pts, (reps, 1))[: self.num_points]
        return {"points": normalize_cloud(pts),
                "label": self.names.index(name)}
