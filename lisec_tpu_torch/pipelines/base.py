"""Pipeline base (port of ``lisec_tpu/pipelines/base.py``, inference).

A pipeline owns the model and its post-processing on one explicit
device. ``"cuda"`` is the default; without a card it raises instead of
running on the CPU, where only the caller's ``device="cpu"`` runs the
plain PyTorch versions of the kernels. Training, the optimizer and the
device mesh come with later slices.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from lisec_tpu_torch.config import Config


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class Pipeline:
    """Subclasses set ``self.model`` (an ``nn.Module`` on
    ``self.device``) in ``__init__`` and implement ``predict``."""

    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Inference outputs from a batch of tensors on ``self.device``."""
        raise NotImplementedError

    @torch.no_grad()
    def infer(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Batch (numpy arrays or tensors) in, outputs on the device out."""
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        return self.predict(batch)
