"""SemanticKITTI dataset (copy of ``lisec_tpu/data/semantickitti.py``).

Real layout: ``sequences/<seq>/velodyne/*.bin`` + ``labels/*.label``
(uint32: semantic class in the lower 16 bits, instance id in the upper
16). Raw labels are remapped to the 19-class learning map (+0 =
ignore/unlabeled). Sequences 00-10 train with 08 as val.
``fixture=True`` generates geometry-correlated synthetic scenes (seeds
``i`` for train, ``40_000 + i`` otherwise).
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import numpy as np

from lisec_tpu_torch.data.fixtures import make_semantic_scene
from lisec_tpu_torch.registry import register_dataset

# Canonical learning map: raw id -> train id (0 = ignored/unlabeled).
LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}
NUM_CLASSES = 20  # 19 + ignore at 0

TRAIN_SEQS = ("00", "01", "02", "03", "04", "05", "06", "07", "09", "10")
VAL_SEQS = ("08",)


def _remap_table() -> np.ndarray:
    table = np.zeros(max(LEARNING_MAP) + 1, np.int32)
    for k, v in LEARNING_MAP.items():
        table[k] = v
    return table


def read_label(path: str) -> np.ndarray:
    """Read .label file -> raw semantic ids (lower 16 bits)."""
    raw = np.fromfile(path, dtype=np.uint32)
    return (raw & 0xFFFF).astype(np.int32)


def remap_labels(raw_semantic: np.ndarray) -> np.ndarray:
    table = _remap_table()
    clipped = np.clip(raw_semantic, 0, len(table) - 1)
    return table[clipped]


@register_dataset("semantickitti")
class SemanticKitti:
    def __init__(self, cfg, split: str = "train"):
        self.fixture = cfg.data.fixture
        self.split = split
        self.num_classes = cfg.data.num_classes or NUM_CLASSES
        if self.fixture:
            self.size = cfg.data.fixture_size
            return
        root = cfg.data.root
        seqs = TRAIN_SEQS if split == "train" else VAL_SEQS
        self.files = []
        for seq in seqs:
            vdir = os.path.join(root, "sequences", seq, "velodyne")
            for p in sorted(glob.glob(os.path.join(vdir, "*.bin"))):
                lab = p.replace("velodyne", "labels").replace(
                    ".bin", ".label")
                self.files.append((p, lab))
        self.size = len(self.files)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if self.fixture:
            seed = i if self.split == "train" else 40_000 + i
            return make_semantic_scene(seed, num_classes=self.num_classes)
        bin_path, label_path = self.files[i]
        points = np.fromfile(bin_path, dtype=np.float32).reshape(-1, 4)
        sample = {"points": points}
        if os.path.exists(label_path):
            sample["point_labels"] = remap_labels(read_label(label_path))
        return sample
