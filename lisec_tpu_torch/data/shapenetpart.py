"""ShapeNetPart dataset (copy of ``lisec_tpu/data/shapenetpart.py``).

Real layout: shapenetcore_partanno_segmentation_benchmark_v0_normal —
``synsetoffset2category.txt`` mapping category names to synset dirs,
each containing txt files of ``x y z nx ny nz part_label``. 16
categories, 50 part labels, per-point labels + one-hot category input.
``fixture=True`` uses the synthetic slab-part mini-dataset.
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import numpy as np

from lisec_tpu_torch.data.fixtures import make_partseg_cloud
from lisec_tpu_torch.data.modelnet40 import normalize_cloud
from lisec_tpu_torch.registry import register_dataset


@register_dataset("shapenetpart")
class ShapeNetPart:
    NUM_CATEGORIES = 16
    NUM_PARTS = 50

    def __init__(self, cfg, split: str = "train"):
        self.num_points = cfg.data.num_points
        self.fixture = cfg.data.fixture
        self.split = split
        self.num_categories = int(
            cfg.model.params.get("num_categories", self.NUM_CATEGORIES))
        self.parts_per_cat = int(cfg.model.params.get("parts_per_cat", 3))
        if self.fixture:
            self.size = cfg.data.fixture_size
            return
        root = cfg.data.root
        with open(os.path.join(root, "synsetoffset2category.txt")) as f:
            pairs = [line.split() for line in f if line.strip()]
        self.categories = {synset: i for i, (_, synset) in enumerate(pairs)}
        self.files = []
        for synset in self.categories:
            for p in sorted(glob.glob(os.path.join(root, synset, "*.txt"))):
                self.files.append((p, self.categories[synset]))
        self.size = len(self.files)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if self.fixture:
            cat = i % self.num_categories
            seed = i if self.split == "train" else 20_000 + i
            pts, labels = make_partseg_cloud(
                seed, cat, self.num_points, self.parts_per_cat)
            return {"points": normalize_cloud(pts),
                    "point_labels": labels, "category": cat}
        path, cat = self.files[i]
        arr = np.loadtxt(path, dtype=np.float32)
        sel = np.arange(len(arr)) % len(arr)
        if len(arr) >= self.num_points:
            sel = sel[: self.num_points]
        else:
            sel = np.resize(sel, self.num_points)
        pts = arr[sel, :3]
        labels = arr[sel, -1].astype(np.int32)
        return {"points": normalize_cloud(pts),
                "point_labels": labels, "category": cat}
