"""SECOND-style sparse-voxel detector (port of
``lisec_tpu/models/second.py``).

Small voxels, mean-VFE, a sparse 3D middle encoder (submanifold and
strided sparse convs, 8x downsample) with a dense masked tail, flatten-z
to BEV, then the BEV backbone and anchor head PointPillars uses. Every
sparse conv is a scatter rulebook plus ``sparse_conv3d_spread``
(``lisec_tpu_torch/ops/sparse_conv.py``), which runs the
``spread_accumulate`` kernel; the voxel list is laid onto its dense grid
by the paint kernel (``segment_sum_dense``). Voxel-list budgets per level
are static config. The JAX package pads every level to one row count and
channel width so that its convs share one compiled kernel; nothing here
needs that.

Dense tensors are (B, C, nz, ny, nx) and the BEV map is NCHW; parameters
are f32 and cast to the compute dtype per layer, as flax does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lisec_tpu_torch.models.common import (
    BN_EPS, BN_MOMENTUM, batch_norm, reset_parameters)
from lisec_tpu_torch.models.pointpillars import (
    FOCAL_PRIOR, AnchorHead, BEVBackbone)
from lisec_tpu_torch.ops.scatter import segment_sum_dense
from lisec_tpu_torch.ops.sparse_conv import (
    SparseConvSpec, build_footprint_coords, build_output_coords,
    build_scatter_rulebook, sparse_conv3d_spread, submanifold_sources)
from lisec_tpu_torch.parallel.mesh import global_sum
from lisec_tpu_torch.utils import prng


NUM_OFFSETS = 27            # every sparse conv here has 3 x 3 x 3 taps


def mean_vfe(voxels: torch.Tensor, num_points: torch.Tensor) -> torch.Tensor:
    """Mean-VFE: (..., P, K, C) + counts (..., P) -> (..., P, C)."""
    k = voxels.shape[-2]
    mask = torch.arange(k, device=voxels.device) < num_points[..., None]
    s = (voxels * mask[..., None].to(voxels.dtype)).sum(dim=-2)
    return s / num_points[..., None].clamp_min(1).to(voxels.dtype)


class SparseConv3D(nn.Module):
    """One sparse conv (weights (K, Cin, Cout)) + BatchNorm + ReLU over a
    batched padded voxel list. BatchNorm runs over all B * V_out rows,
    the zero rows beyond the valid ones included, as in the JAX
    package."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.zeros(NUM_OFFSETS, in_channels, out_channels))
        self.scale = nn.Parameter(torch.ones(out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer("mean", torch.zeros(out_channels))
        self.register_buffer("var", torch.ones(out_channels))

    def forward(self, feats: torch.Tensor, out_of: torch.Tensor,
                valid: torch.Tensor,
                sources: Optional[torch.Tensor] = None) -> torch.Tensor:
        """feats (B, V_in, Cin), out_of (B, K, V_in) scatter rulebook,
        valid (B, V_out), sources the rulebook's inverse where the caller
        holds it (B, K, V_out) -> (B, V_out, Cout) in the compute
        dtype."""
        y = sparse_conv3d_spread(
            feats.to(self.dtype), out_of, self.weight.to(self.dtype),
            v_out=valid.shape[1], sources=sources)
        # The f32 sum returns to the compute dtype before BatchNorm.
        y = batch_norm(y.to(self.dtype).float(), self, -1).to(self.dtype)
        return torch.where(valid[..., None], torch.relu(y), 0.0)


class DenseConv3D(nn.Module):
    """One conv of the dense tail: 3^3 conv (padding 1, no bias) -> masked
    BatchNorm -> ReLU -> zero outside the active set. The statistics of
    the masked BatchNorm count active cells only (the dense-grid
    equivalent of normalising over a voxel list), with E[x^2] - mu^2
    clipped at 0, and ``x * s + t`` is applied in f32."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.weight = nn.Parameter(
            torch.zeros(out_channels, in_channels, 3, 3, 3))
        self.scale = nn.Parameter(torch.ones(out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer("mean", torch.zeros(out_channels))
        self.register_buffer("var", torch.ones(out_channels))

    def forward(self, x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """x (B, Cin, nz, ny, nx), active (B, 1, nz', ny', nx') of the
        OUTPUT grid, 0 or 1 in the compute dtype."""
        h = F.conv3d(x.to(self.dtype), self.weight.to(self.dtype),
                     stride=self.stride, padding=1)
        hf = h.float()
        if self.training:
            # Under a data mesh the global batch's active cells.
            m = active.float()
            cnt = global_sum(m.sum()).clamp_min(1.0)
            hm = hf * m
            mu = global_sum(hm.sum(dim=(0, 2, 3, 4))) / cnt
            var = (global_sum((hm * hm).sum(dim=(0, 2, 3, 4))) / cnt
                   - mu * mu).clamp_min(0.0)
            with torch.no_grad():
                self.mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mu)
                self.var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
        else:
            mu, var = self.mean, self.var
        s = self.scale * torch.rsqrt(var + BN_EPS)
        t = self.bias - s * mu
        shape = (1, -1, 1, 1, 1)
        y = (hf * s.view(shape) + t.view(shape)).to(self.dtype)
        return torch.relu(y) * active


def _down_spec(grid: Tuple[int, int, int]) -> SparseConvSpec:
    return SparseConvSpec((3, 3, 3), (2, 2, 2), (1, 1, 1), grid)


class SparseMiddleEncoder(nn.Module):
    """Submanifold + strided sparse conv stack, 8x downsample, then
    flatten-z to a dense BEV map.

    ``grid`` is (nz, ny, nx) of the input voxel grid; ``level_budgets``
    the static voxel-list size of each level. Levels >=
    ``dense_from_level`` run as a dense tail: the strided conv INTO that
    level still runs sparse, its output list is laid onto the level's
    dense grid together with an active-set indicator, and every later
    conv is a dense conv masked to the active set, which a strided conv
    propagates by the max-pool that is exactly its touched set. A budget
    that overflows keeps the lowest cell ids, that is the lowest z
    layers. ``downsample="footprint"`` restricts each strided conv's
    output set to the cells whose 2x2x2 input footprint is occupied.

    ``sparse`` and ``dense`` hold the layers in flax's creation order
    (``SparseConv3D_i``; ``Conv_j`` with ``MaskedBatchNorm_j``)."""

    def __init__(self, in_channels: int, grid: Tuple[int, int, int],
                 channels: Sequence[int] = (16, 32, 64, 64),
                 level_budgets: Sequence[int] = (16000, 20480, 26624, 18432),
                 subm_per_level: int = 2, dense_from_level: int = 2,
                 downsample: str = "dilate",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if downsample not in ("dilate", "footprint"):
            raise ValueError(f"unknown downsample {downsample!r}")
        self.grid = tuple(grid)
        self.channels = tuple(channels)
        self.level_budgets = tuple(int(b) for b in level_budgets)
        self.subm_per_level = subm_per_level
        self.downsample = downsample
        self.dtype = dtype
        n_levels = len(self.channels)
        self.dense_from = min(max(dense_from_level, 1), n_levels)

        self.sparse = nn.ModuleList()
        cin = in_channels
        for level in range(self.dense_from):
            ch = self.channels[level]
            for _ in range(subm_per_level):
                self.sparse.append(SparseConv3D(cin, ch, dtype))
                cin = ch
            if level < n_levels - 1:
                cin = self.channels[level + 1]
                self.sparse.append(SparseConv3D(ch, cin, dtype))
        self.dense = nn.ModuleList()
        for level in range(self.dense_from, n_levels):
            ch = self.channels[level]
            if level > self.dense_from:
                self.dense.append(DenseConv3D(cin, ch, 2, dtype))
                cin = ch
            for _ in range(subm_per_level):
                self.dense.append(DenseConv3D(cin, ch, 1, dtype))
                cin = ch
        self.out_channels = cin

    @property
    def out_grid(self) -> Tuple[int, int, int]:
        grid = self.grid
        for _ in range(len(self.channels) - 1):
            grid = _down_spec(grid).grid_out
        return grid

    def _pool_active(self, active: torch.Tensor) -> torch.Tensor:
        """The active set after a k3/s2/p1 strided conv."""
        a = active.float()
        if self.downsample == "footprint":
            # Active iff the 2x2x2 input footprint is occupied; the high
            # edges of odd grids are padded (the output size is
            # ceil(g / 2)).
            pads = [p for g in reversed(a.shape[2:]) for p in (0, g % 2)]
            a = F.max_pool3d(F.pad(a, pads), 2, stride=2)
        else:
            a = F.max_pool3d(a, 3, stride=2, padding=1)
        return a.to(active.dtype)

    def forward(self, feats: torch.Tensor, coords: torch.Tensor,
                num_voxels: torch.Tensor) -> torch.Tensor:
        """feats (B, V, C), coords (B, V, 3) int32 [z, y, x] sorted by
        cell id, num_voxels (B,) -> BEV (B, nz/8 * C_last, ny/8, nx/8)
        with channel index ``z * C_last + c``."""
        b, v, _ = feats.shape
        dev = feats.device
        grid = self.grid
        n_levels = len(self.channels)
        x = feats
        cur_coords, cur_num = coords, num_voxels
        cur_valid = torch.arange(v, device=dev) < num_voxels[:, None]
        layers = iter(self.sparse)

        for level in range(self.dense_from):
            # Submanifold convs at this resolution (out set = in set).
            spec = SparseConvSpec((3, 3, 3), (1, 1, 1), (1, 1, 1), grid)
            srb = build_scatter_rulebook(cur_coords, cur_num, cur_coords,
                                         cur_num, spec)
            # Its inverse, for the spread, once for the level's layers.
            sources = submanifold_sources(srb)
            for _ in range(self.subm_per_level):
                x = next(layers)(x, srb, cur_valid, sources)
            if level < n_levels - 1:
                # Strided downsample to the next level's active set
                # (sparse even when the next level is dense).
                dspec = _down_spec(grid)
                budget = self.level_budgets[level + 1]
                build = (build_footprint_coords
                         if self.downsample == "footprint"
                         else build_output_coords)
                out_coords, out_num = build(cur_coords, cur_num, dspec,
                                            max_out=budget)
                dsrb = build_scatter_rulebook(cur_coords, cur_num,
                                              out_coords, out_num, dspec)
                out_valid = torch.arange(budget, device=dev) \
                    < out_num[:, None]
                x = next(layers)(x, dsrb, out_valid)
                cur_coords, cur_num, cur_valid = (out_coords, out_num,
                                                  out_valid)
                grid = dspec.grid_out

        # Lay the voxel list (sorted, distinct cells) onto its dense grid;
        # the per-cell row count is the active-set indicator.
        nz, ny, nx = grid
        lin = (cur_coords[..., 0] * ny + cur_coords[..., 1]) * nx \
            + cur_coords[..., 2]
        lin = torch.where(cur_valid, lin, nz * ny * nx).to(torch.int32)
        tab, cnt = segment_sum_dense(x, lin, nz * ny * nx)
        x = tab.view(b, nz, ny, nx, -1).permute(0, 4, 1, 2, 3).to(self.dtype)
        active = (cnt > 0).view(b, 1, nz, ny, nx).to(self.dtype)

        for layer in self.dense:
            if layer.stride == 2:
                # Zero input cells contribute nothing, so this equals the
                # sparse strided conv on the untruncated active set.
                active = self._pool_active(active)
            x = layer(x, active)

        # Flatten z into channels: channel z * C + c.
        _, c_last, nz, ny, nx = x.shape
        return x.permute(0, 2, 1, 3, 4).reshape(b, nz * c_last, ny, nx)


class SECONDNet(nn.Module):
    """Mean-VFE -> sparse middle encoder -> BEV backbone -> anchor head.

    ``voxels`` is (B, P, C) per-voxel mean features (from
    ``voxelize_mean_batch``) or the (B, P, K, C) point table of
    ``voxelize_batch``, which goes through :func:`mean_vfe` here."""

    # flax's initializers that are not its defaults
    # (``models.common.reset_parameters``): the encoder's convs draw
    # with variance 2 / fan_in, the head's class bias is the focal-loss
    # prior.
    FLAX_INITS = (
        (r"^params/SparseMiddleEncoder_0/(SparseConv3D|Conv)_\d+/kernel$",
         prng.variance_scaling(2.0, "fan_in", "truncated_normal")),
        FOCAL_PRIOR)

    def __init__(self, num_classes: int, grid_size: Tuple[int, int, int],
                 num_anchors_per_cell: int, in_channels: int = 4,
                 level_budgets: Sequence[int] = (16000, 20480, 26624, 18432),
                 encoder_channels: Sequence[int] = (16, 32, 64, 64),
                 dense_from_level: int = 2,
                 bev_layers: Sequence[int] = (5, 5),
                 bev_filters: Sequence[int] = (128, 256),
                 bev_strides: Sequence[int] = (1, 2),
                 bev_up_strides: Sequence[int] = (1, 2),
                 bev_up_filters: Sequence[int] = (256, 256),
                 downsample: str = "dilate",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        nx, ny, nz = grid_size
        self.dtype = dtype
        self.encoder = SparseMiddleEncoder(
            in_channels, (nz, ny, nx), channels=encoder_channels,
            level_budgets=level_budgets, dense_from_level=dense_from_level,
            downsample=downsample, dtype=dtype)
        bev_channels = self.encoder.out_grid[0] * self.encoder.out_channels
        self.backbone = BEVBackbone(
            bev_channels, bev_layers, bev_strides, bev_filters,
            bev_up_strides, bev_up_filters, dtype=dtype)
        self.head = AnchorHead(sum(bev_up_filters), num_classes,
                               num_anchors_per_cell, dtype=dtype)

    def forward(self, voxels: torch.Tensor, coords: torch.Tensor,
                num_points: torch.Tensor, num_voxels: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        if voxels.dim() == 4:
            voxels = mean_vfe(voxels, num_points)
        bev = self.encoder(voxels.to(self.dtype), coords, num_voxels)
        return self.head(self.backbone(bev))

    def reset_parameters(self, seed: int) -> None:
        """The JAX package's initial weights from ``seed``
        (``models.common.reset_parameters``)."""
        reset_parameters(self, seed)
