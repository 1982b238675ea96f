"""PointPillars (port of ``lisec_tpu/models/pointpillars.py``:
``PillarFeatureNet``, ``BEVBackbone``, ``AnchorHead``, ``PointPillars``
and ``PointPillarsFused``), NCHW.

``PointPillarsFused`` encodes raw padded points with the fused pillar
encoder (one kernel at inference); ``PointPillars`` is the voxel-buffer
model of ``model.params.fused: false``: the voxelizer's (P, K, 4) table
through ``PillarFeatureNet``, scattered onto the canvas.

Canonical geometry: range [(0, -39.68, -3), (69.12, 39.68, 1)], pillar
0.16 x 0.16 -> 432 x 496 BEV grid; PFN 9 -> 64; a 3-block strided conv
backbone (64/128/256) with an upsample-concat neck (3 x 128); an
SSD-style 1x1 anchor head.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lisec_tpu_torch.models.common import (
    BatchNorm, ConvBNRelu, Dense, batch_norm, reset_parameters)
from lisec_tpu_torch.models.pillar_encoder import FusedPillarEncoder
from lisec_tpu_torch.ops.scatter import pillar_scatter
from lisec_tpu_torch.utils import prng

# Focal-loss prior: bias = -log((1 - pi) / pi) with pi = 0.01, the
# initial class bias of the anchor head (a ``FLAX_INITS`` entry).
CLS_BIAS_INIT = -4.595
FOCAL_PRIOR = (r"^params/AnchorHead_0/Conv_0/bias$",
               prng.constant(CLS_BIAS_INIT))


class PillarFeatureNet(nn.Module):
    """Decorate each pillar's points with their offsets from the pillar's
    mean and centre, then Dense (no bias) -> BatchNorm -> ReLU -> a max
    over the pillar's points.

    voxels (..., P, K, 4) raw points, coords (..., P, 3) [z, y, x],
    num_points (..., P) -> (..., P, C) in the model's dtype. As in flax
    with ``dtype=``, the Dense and the BatchNorm run in that dtype (the
    statistics in f32). The batch statistics cover every (P, K) slot,
    the zero rows of empty slots included, as the JAX package's do (the
    features are masked before the bias-free Dense). Empty slots take
    the dtype's lowest value in the max; a pillar without points gives
    0."""

    def __init__(self, num_filters: int = 64,
                 voxel_size: Tuple[float, float] = (0.16, 0.16),
                 pc_range_min: Tuple[float, float] = (0.0, -39.68),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.pc_range_min = tuple(pc_range_min)
        self.dtype = dtype
        # [x, y, z, r, xyz - pillar mean, xy - pillar centre]
        self.dense = Dense(9, num_filters, bias=False)
        self.bn = BatchNorm(num_filters)

    def forward(self, voxels: torch.Tensor, coords: torch.Tensor,
                num_points: torch.Tensor) -> torch.Tensor:
        k = voxels.shape[-2]
        mask = (torch.arange(k, device=voxels.device)
                < num_points[..., None])                    # (..., P, K)
        fmask = mask[..., None].to(voxels.dtype)
        xyz = voxels[..., :3]
        counts = num_points.clamp_min(1).to(voxels.dtype)
        mean = (xyz * fmask).sum(dim=-2) / counts[..., None]
        f_cluster = xyz - mean[..., None, :]
        # Offset from the pillar's centre on the grid.
        px = ((coords[..., 2].to(voxels.dtype) + 0.5) * self.voxel_size[0]
              + self.pc_range_min[0])
        py = ((coords[..., 1].to(voxels.dtype) + 0.5) * self.voxel_size[1]
              + self.pc_range_min[1])
        f_center = torch.stack([voxels[..., 0] - px[..., None],
                                voxels[..., 1] - py[..., None]], dim=-1)
        feats = torch.cat([voxels, f_cluster, f_center], dim=-1) * fmask

        h = feats.to(self.dtype) @ self.dense.weight.to(self.dtype).T
        h = batch_norm(h.float(), self.bn, -1).to(self.dtype)
        h = torch.relu(h)
        h = torch.where(mask[..., None], h,
                        torch.finfo(h.dtype).min).amax(dim=-2)
        return torch.where(num_points[..., None] > 0, h, 0.0)


class BEVBackbone(nn.Module):
    """(B, C, H, W) -> (B, sum(up_filters), H/2, W/2).

    ``layers`` holds the ConvBNRelu blocks in flax's creation order (per
    block: the strided conv, ``layer_nums[i]`` convs, the up branch), so
    index i is flax's ``ConvBNRelu_i``."""

    def __init__(self, in_channels: int,
                 layer_nums: Sequence[int] = (3, 5, 5),
                 strides: Sequence[int] = (2, 2, 2),
                 filters: Sequence[int] = (64, 128, 256),
                 up_strides: Sequence[int] = (1, 2, 4),
                 up_filters: Sequence[int] = (128, 128, 128),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer_nums = tuple(layer_nums)
        self.layers = nn.ModuleList()
        cin = in_channels
        for n, s, f, u, uf in zip(layer_nums, strides, filters, up_strides,
                                  up_filters):
            self.layers.append(ConvBNRelu(cin, f, 3, s, dtype=dtype))
            for _ in range(n):
                self.layers.append(ConvBNRelu(f, f, 3, dtype=dtype))
            if u > 1:
                self.layers.append(ConvBNRelu(f, uf, u, u, transpose=True,
                                              dtype=dtype))
            else:
                self.layers.append(ConvBNRelu(f, uf, 3, dtype=dtype))
            cin = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ups = []
        i = 0
        for n in self.layer_nums:
            for layer in self.layers[i:i + n + 1]:
                x = layer(x)
            ups.append(self.layers[i + n + 1](x))
            i += n + 2
        return torch.cat(ups, dim=1)


class Conv1x1(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, in_features, 1, 1))
        self.bias = nn.Parameter(torch.zeros(features))


class AnchorHead(nn.Module):
    """1x1 conv head: class logits, box deltas, direction logits.

    Outputs are (B, H * W * A, .) in (y, x, anchor) order, the anchor
    generator's layout, and float32."""

    def __init__(self, in_channels: int, num_classes: int,
                 num_anchors_per_cell: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.num_anchors_per_cell = num_anchors_per_cell
        self.dtype = dtype
        a = num_anchors_per_cell
        self.cls = Conv1x1(in_channels, a * num_classes)
        self.box = Conv1x1(in_channels, a * 7)
        self.dir = Conv1x1(in_channels, a * 2)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        b, _, h, w = x.shape
        a = self.num_anchors_per_cell
        x = x.to(self.dtype)

        def run(conv, k):
            y = F.conv2d(x, conv.weight.to(self.dtype),
                         conv.bias.to(self.dtype))
            # NHWC before the reshape keeps the (y, x, anchor) order.
            return y.permute(0, 2, 3, 1).reshape(b, h * w * a, k).float()
        return {"cls": run(self.cls, self.num_classes),
                "box": run(self.box, 7), "dir": run(self.dir, 2)}


class PointPillarsFused(nn.Module):
    """Raw padded points (B, N, 4) + mask (B, N) in, per-anchor
    predictions out. ``train()`` / ``eval()`` select batch or running
    BatchNorm statistics in the encoder and every conv block."""

    # flax's initializers that are not its defaults
    # (``models.common.reset_parameters``).
    FLAX_INITS = (FOCAL_PRIOR,)

    def __init__(self, num_classes: int, grid_size: Tuple[int, int, int],
                 voxel_size: Tuple[float, float],
                 pc_range: Tuple[float, ...], num_anchors_per_cell: int,
                 pfn_filters: int = 64,
                 backbone_layers: Sequence[int] = (3, 5, 5),
                 backbone_filters: Sequence[int] = (64, 128, 256),
                 backbone_strides: Sequence[int] = (2, 2, 2),
                 backbone_up_strides: Sequence[int] = (1, 2, 4),
                 backbone_up_filters: Sequence[int] = (128, 128, 128),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.grid = (grid_size[0], grid_size[1])
        self.encoder = FusedPillarEncoder(
            num_filters=pfn_filters, pc_range=pc_range,
            voxel_size=voxel_size, grid=self.grid, dtype=dtype)
        self.backbone = BEVBackbone(
            pfn_filters, backbone_layers, backbone_strides,
            backbone_filters, backbone_up_strides, backbone_up_filters,
            dtype=dtype)
        self.head = AnchorHead(sum(backbone_up_filters), num_classes,
                               num_anchors_per_cell, dtype=dtype)

    def forward(self, points: torch.Tensor,
                point_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        nx, ny = self.grid
        canvas = self.encoder(points, point_mask)          # (B, ny*nx, C)
        b, _, c = canvas.shape
        # An NHWC view: channels-last memory, which cuDNN takes as is.
        x = canvas.view(b, ny, nx, c).permute(0, 3, 1, 2)
        return self.head(self.backbone(x))

    def reset_parameters(self, seed: int) -> None:
        """The JAX package's initial weights from ``seed``
        (``models.common.reset_parameters``)."""
        reset_parameters(self, seed)


class PointPillars(nn.Module):
    """The voxel-buffer PointPillars: the voxelizer's fixed-budget output
    -> ``PillarFeatureNet`` -> ``pillar_scatter`` -> backbone -> head.
    ``forward(voxels (B, P, K, 4), coords (B, P, 3), num_points (B, P),
    num_voxels (B,))`` returns per-anchor predictions."""

    FLAX_KEYS = "pointpillars"

    # flax's initializers that are not its defaults
    # (``models.common.reset_parameters``).
    FLAX_INITS = (FOCAL_PRIOR,)

    def __init__(self, num_classes: int, grid_size: Tuple[int, int, int],
                 voxel_size: Tuple[float, float],
                 pc_range_min: Tuple[float, float],
                 num_anchors_per_cell: int, pfn_filters: int = 64,
                 backbone_layers: Sequence[int] = (3, 5, 5),
                 backbone_filters: Sequence[int] = (64, 128, 256),
                 backbone_strides: Sequence[int] = (2, 2, 2),
                 backbone_up_strides: Sequence[int] = (1, 2, 4),
                 backbone_up_filters: Sequence[int] = (128, 128, 128),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.grid = (grid_size[0], grid_size[1])
        self.pfn = PillarFeatureNet(pfn_filters, voxel_size, pc_range_min,
                                    dtype=dtype)
        self.backbone = BEVBackbone(
            pfn_filters, backbone_layers, backbone_strides,
            backbone_filters, backbone_up_strides, backbone_up_filters,
            dtype=dtype)
        self.head = AnchorHead(sum(backbone_up_filters), num_classes,
                               num_anchors_per_cell, dtype=dtype)

    def forward(self, voxels: torch.Tensor, coords: torch.Tensor,
                num_points: torch.Tensor,
                num_voxels: torch.Tensor) -> Dict[str, torch.Tensor]:
        nx, ny = self.grid
        feats = self.pfn(voxels, coords, num_points)        # (B, P, C)
        canvas = pillar_scatter(feats, coords, num_voxels, ny=ny, nx=nx)
        return self.head(self.backbone(canvas))

    def reset_parameters(self, seed: int) -> None:
        """The JAX package's initial weights from ``seed``
        (``models.common.reset_parameters``)."""
        reset_parameters(self, seed)
