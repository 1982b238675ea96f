"""Public Python API (port of ``lisec_tpu/api.py``).

``load_cloud -> preprocess -> build_model -> infer -> boxes/labels``, and
``train(cfg)``. ``preprocess`` pads to the config budgets on the host;
``infer`` and ``train`` run the pipeline on its device. The device is
explicit and defaults to ``"cuda"``; without a card that raises
(``device="cpu"`` runs the plain PyTorch path). The weights live in the pipeline's model, so ``infer``
takes no separate state.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from lisec_tpu_torch.config import Config, load_config  # noqa: F401
from lisec_tpu_torch.data.collate import pad_points
from lisec_tpu_torch.pipelines.base import same_device


def load_cloud(path: str) -> np.ndarray:
    """Load a point cloud from disk into an (N, C) float32 array.

    Supported formats: ``.bin`` (KITTI velodyne, N x 4 float32), ``.npy``,
    ``.npz`` (first array), ``.txt``/``.pts`` (whitespace separated).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bin":
        raw = np.fromfile(path, dtype=np.float32)
        if raw.size % 4:
            raise ValueError(
                f"{path!r}: KITTI .bin must hold N x 4 float32 values, "
                f"got {raw.size} floats (not divisible by 4)")
        return raw.reshape(-1, 4)
    if ext == ".npy":
        return np.load(path).astype(np.float32)
    if ext == ".npz":
        data = np.load(path)
        return data[list(data.keys())[0]].astype(np.float32)
    if ext in (".txt", ".pts", ".xyz"):
        return np.loadtxt(path, dtype=np.float32)
    raise ValueError(f"unsupported cloud format: {path!r}")


def preprocess(cloud: np.ndarray, cfg: Config) -> Dict[str, np.ndarray]:
    """Pad one cloud to the config budgets: 'points' (max_points, C) and
    'point_mask' (max_points,)."""
    return pad_points(cloud, cfg.budget.max_points)


def build_model(cfg: Config, device="cuda"):
    """Build the pipeline object for a config (registry lookup) on
    ``device``."""
    from lisec_tpu_torch.pipelines import detection, partseg  # noqa: F401
    from lisec_tpu_torch.registry import get_pipeline
    return get_pipeline(cfg.model.name)(cfg, device=device)


def infer(pipeline, batch, device="cuda") -> Dict[str, torch.Tensor]:
    """Run the pipeline's inference on a batch; ``device`` must name the
    pipeline's device."""
    if not same_device(device, pipeline.device):
        raise ValueError(f"pipeline is on {pipeline.device}, "
                         f"infer asked for {device!r}")
    return pipeline.infer(batch)


def train(cfg: Config, device="cuda", progress: bool = True):
    """Train a config from scratch on ``device``; returns (pipeline,
    history), the trained weights being the pipeline's model."""
    from lisec_tpu_torch.training.loop import run_training
    return run_training(cfg, device=device, progress=progress)
