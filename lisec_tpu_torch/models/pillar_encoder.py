"""Fused pillar encoder, inference path (port of
``lisec_tpu/models/pillar_encoder.py::FusedPillarEncoder``).

The PFN is per-point-then-per-pillar-max, so no voxel buffer is needed:

    Dense([pts4, xyz - mean_c, xy - center_c])
      = [pts4, xyz, xy] @ W  -  mean_c @ W[4:7]  -  center_c @ W[7:9]

and inference BatchNorm folds into (W, t) with max and relu still
commuting, so one kernel computes the canvas
(``lisec_tpu_torch/ops/cuda/encoder_kernel.py``). The training path
(batch statistics, paint/unpaint) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from lisec_tpu_torch.ops.cuda.encoder_kernel import pillar_canvas_fused

BN_EPS = 1e-3


class FusedPillarEncoder(nn.Module):
    """points (B, N, 4) + mask (B, N) -> BEV canvas (B, ny * nx, C)."""

    def __init__(self, num_filters: int = 64,
                 pc_range: Tuple[float, ...] = (
                     0.0, -39.68, -3.0, 69.12, 39.68, 1.0),
                 voxel_size: Tuple[float, float] = (0.16, 0.16),
                 grid: Tuple[int, int] = (432, 496),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pc_range = tuple(pc_range)
        self.voxel_size = tuple(voxel_size)
        self.grid = tuple(grid)                     # (nx, ny)
        self.dtype = dtype
        c = num_filters
        self.kernel = nn.Parameter(torch.zeros(9, c))
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def folded_weights(self):
        """Inference BN folded into the PFN: (w (9, C), t (C,)) with
        relu(s * (feats @ kernel) + t') = relu(feats @ w + t)."""
        s = self.scale * torch.rsqrt(self.var + BN_EPS)
        t = self.bias - s * self.mean
        return (self.kernel * s[None, :]).contiguous(), t.contiguous()

    def forward(self, points: torch.Tensor,
                point_mask: torch.Tensor) -> torch.Tensor:
        w, t = self.folded_weights()
        return pillar_canvas_fused(points.float().contiguous(), point_mask,
                                   w, t, grid=self.grid,
                                   voxel_size=self.voxel_size,
                                   pc_range=self.pc_range,
                                   out_dtype=self.dtype)
