"""Fused pillar encoder (port of
``lisec_tpu/models/pillar_encoder.py::FusedPillarEncoder``).

The PFN is per-point-then-per-pillar-max, so no voxel buffer is needed:

    Dense([pts4, xyz - mean_c, xy - center_c])
      = [pts4, xyz, xy] @ W  -  mean_c @ W[4:7]  -  center_c @ W[7:9]

**Inference** (``eval()`` mode): BatchNorm folds into (W, t) with max and
relu still commuting, so one kernel computes the canvas
(``lisec_tpu_torch/ops/cuda/encoder_kernel.py``).

**Training** (``train()`` mode): BatchNorm needs the batch statistics of
the per-point features, so the steps stay apart. The points are sorted by
cell; the paint kernel gives every cell's xyz sums and count and one
``pillar_decorate`` launch routes them back to the points and decorates
them (the decoration has no parameters and runs under ``no_grad``); then
``feats @ W -> BN -> relu`` is plain PyTorch and ``segment_max_sorted``
(paint forward, one ``segment_max_backward`` launch backward,
``lisec_tpu_torch/ops/scatter.py``) reduces the points to the canvas.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from lisec_tpu_torch.models.common import BN_EPS, BN_MOMENTUM
from lisec_tpu_torch.ops.cuda.encoder_kernel import (
    pillar_canvas_fused, pillar_cells)
from lisec_tpu_torch.ops.cuda.segment_paint import segment_paint
from lisec_tpu_torch.ops.cuda.segment_unpaint import pillar_decorate
from lisec_tpu_torch.ops.scatter import segment_max_sorted
from lisec_tpu_torch.parallel.mesh import global_mean, world_size


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
        points = points.float().contiguous()
        if self.training:
            return self._train_path(points, point_mask)
        w, t = self.folded_weights()
        return pillar_canvas_fused(points, point_mask.bool(), w, t,
                                   grid=self.grid,
                                   voxel_size=self.voxel_size,
                                   pc_range=self.pc_range,
                                   out_dtype=self.dtype)

    @torch.no_grad()
    def decorate_sorted(self, points: torch.Tensor,
                        point_mask: torch.Tensor):
        """Sort the points by cell and decorate them: returns (cell_s
        (B, N) int32 ascending, invalid = nx * ny; feats (B, N, 9) f32
        ``[x, y, z, r, xyz - cell mean, xy - cell centre]``, zero rows
        where invalid)."""
        nx, ny = self.grid
        ncells = nx * ny
        r = self.pc_range
        cell, _, _, _ = pillar_cells(points, point_mask, grid=self.grid,
                                     voxel_size=self.voxel_size,
                                     pc_range=r)
        cell_s, order = torch.sort(cell, dim=1, stable=True)
        pts_s = torch.gather(points, 1, order[..., None].expand(-1, -1, 4))
        ones = (cell_s < ncells).float()[..., None]

        # Per-cell xyz sums and count, routed back to the cell's points.
        stats = segment_paint(torch.cat([pts_s[..., :3] * ones, ones], -1),
                              cell_s, num_cells=ncells,
                              num_max=0)                        # (B, NC, 4)
        feats = pillar_decorate(pts_s, cell_s, stats, grid=self.grid,
                                voxel_size=self.voxel_size, pc_range=r)
        return cell_s, feats

    def _train_path(self, points, point_mask):
        nx, ny = self.grid
        cell_s, feats = self.decorate_sorted(points, point_mask)
        h = feats.to(self.dtype) @ self.kernel.to(self.dtype)  # (B, N, C)
        h32 = h.float()
        # Batch statistics over all B * N rows, the zero rows of masked
        # and out-of-range points included; the biased variance. Under a
        # data mesh over the global batch's rows, in two passes as
        # ``var`` takes them.
        [mu] = global_mean([h32], (0, 1))
        if world_size() == 1:
            var = h32.var(dim=(0, 1), unbiased=False)
        else:
            [var] = global_mean([(h32 - mu).square()], (0, 1))
        with torch.no_grad():
            self.mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mu)
            self.var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
        s = self.scale * torch.rsqrt(var + BN_EPS)
        t = self.bias - s * mu
        hr = torch.relu((h32 * s + t).to(self.dtype))
        canvas, count = segment_max_sorted(hr, cell_s, nx * ny)
        canvas = torch.where(count[..., None] > 0.0, canvas, 0.0)
        return canvas.to(self.dtype)
