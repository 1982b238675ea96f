"""SECOND inference in plain PyTorch, float32, for the reference.

Yan, Mao and Li, "SECOND: Sparsely Embedded Convolutional Detection",
Sensors 2018: small voxels with the mean of their points, a sparse 3D
middle encoder (submanifold convs at each level, a strided sparse conv
between levels, 8x down), flattened to a BEV map, then the BEV backbone
and anchor heads of PointPillars.

As the configuration states it: each voxel holds the first
``max_points_per_voxel`` of its points (in point order) and a cloud the
``max_voxels`` lowest cell ids; a strided conv's output set is every
cell under one of its taps, cut to the level's budget by lowest cell id;
levels from ``dense_from_level`` on run as dense 3^3 convs masked to the
active set. Each sparse conv is written gather-form here: for every
output cell and tap, the input row found by a binary search over the
level's sorted cell ids. Nothing here uses the port.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.pointpillars import (
    Cast, _bn, _same, backbone, head)

OFFSETS = list(itertools.product(range(3), repeat=3))   # (z, y, x) taps


def _grid(cfg) -> Tuple[int, int, int]:
    """(nz, ny, nx)."""
    r = cfg["voxel"]["point_cloud_range"]
    vs = cfg["voxel"]["voxel_size"]
    return tuple(int(round((r[i + 3] - r[i]) / vs[i])) for i in (2, 1, 0))


def _lin(z, y, x, grid):
    nz, ny, nx = grid
    inb = (z >= 0) & (z < nz) & (y >= 0) & (y < ny) & (x >= 0) & (x < nx)
    return torch.where(inb, (z * ny + y) * nx + x, nz * ny * nx)


def voxelize_mean(p: torch.Tensor, cfg: Dict):
    """One cloud's valid points (n, 4) -> (coords (V, 3) [z, y, x] by
    ascending cell id, mean features (V, 4))."""
    r = cfg["voxel"]["point_cloud_range"]
    vs = cfg["voxel"]["voxel_size"]
    nz, ny, nx = _grid(cfg)
    idx = []
    for axis, size in enumerate((nx, ny, nz)):
        # floor((v - lo) * (1 / size)) in float32: the reciprocal multiply
        # that the configuration's jitted reference program makes of the
        # division.
        inv = float(np.float32(1.0) / np.float32(vs[axis]))
        idx.append(torch.floor((p[:, axis] - r[axis]) * inv).long())
    ix, iy, iz = idx
    ok = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0)
          & (iz < nz))
    cell = ((iz * ny + iy) * nx + ix)[ok]
    pts = p[ok]
    cell_s, order = torch.sort(cell, stable=True)
    pts = pts[order]
    cells, first, counts = torch.unique_consecutive(
        cell_s, return_inverse=True, return_counts=True)
    start = torch.cumsum(counts, 0) - counts
    within = torch.arange(cell_s.numel(), device=p.device) - start[first]
    keep = (within < int(cfg["budget"]["max_points_per_voxel"])) \
        & (first < int(cfg["budget"]["max_voxels"]))
    v = min(cells.numel(), int(cfg["budget"]["max_voxels"]))
    sums = torch.zeros((v, p.shape[1]), device=p.device).index_add_(
        0, first[keep], pts[keep])
    cnt = torch.zeros((v,), device=p.device).index_add_(
        0, first[keep], torch.ones_like(first[keep], dtype=torch.float32))
    cells = cells[:v]
    coords = torch.stack([cells // (ny * nx), (cells // nx) % ny,
                          cells % nx], 1)
    return coords, sums / cnt[:, None]


def strided_outputs(coords: torch.Tensor, grid_in, budget: int):
    """Output cells of a 3^3 stride-2 padding-1 conv: every cell with an
    input under one of its taps, the ``budget`` lowest ids kept."""
    go = tuple((g - 1) // 2 + 1 for g in grid_in)
    cand = []
    for t in OFFSETS:
        num = coords + 1 - torch.tensor(t, device=coords.device)
        even = (num % 2 == 0).all(1)
        o = torch.div(num, 2, rounding_mode="floor")
        lin = _lin(o[:, 0], o[:, 1], o[:, 2], go)
        cand.append(torch.where(even, lin, go[0] * go[1] * go[2]))
    lin = torch.unique(torch.cat(cand))
    lin = lin[lin < go[0] * go[1] * go[2]][:budget]
    coords_out = torch.stack([lin // (go[1] * go[2]),
                              (lin // go[2]) % go[1], lin % go[2]], 1)
    return coords_out, go


def sparse_conv(x: torch.Tensor, coords_in: torch.Tensor, grid_in,
                coords_out: torch.Tensor, stride: int, kern: torch.Tensor,
                lowp: Cast):
    """y[o] = sum over taps k of x[in(o * stride - 1 + offset_k)] @ W_k;
    returns (y, the number of (output, tap) pairs that found an input)."""
    lin_in = _lin(coords_in[:, 0], coords_in[:, 1], coords_in[:, 2],
                  grid_in)
    sentinel = grid_in[0] * grid_in[1] * grid_in[2]
    y = torch.zeros((coords_out.shape[0], kern.shape[2]), device=x.device)
    pairs = 0
    xl = lowp(x)
    for k, t in enumerate(OFFSETS):
        tap = coords_out * stride - 1 + torch.tensor(t, device=x.device)
        q = _lin(tap[:, 0], tap[:, 1], tap[:, 2], grid_in)
        pos = torch.searchsorted(lin_in, q).clamp(max=max(len(lin_in) - 1,
                                                          0))
        hit = (lin_in[pos] == q) & (q < sentinel)
        rows = torch.nonzero(hit)[:, 0]
        pairs += int(rows.numel())
        y.index_add_(0, rows, xl[pos[rows]] @ lowp(kern[k]))
    return y, pairs


def encoder(p: torch.Tensor, w: Dict, cfg: Dict, lowp: Cast = _same,
            work: List = None, calibrate: bool = False,
            enc: str = "SparseMiddleEncoder_0"):
    """One cloud's valid points -> its BEV map (nz' * C, ny', nx'), the
    channel ``z * C + c``. ``work`` collects each sparse conv's (rows in,
    rows out, pairs, C in, C out, list sizes in and out); ``calibrate``
    sets each BatchNorm's running statistics to its input's as it goes
    (over the active cells of a level)."""
    prm = cfg["model"]["params"]
    budgets = prm.get("level_budgets")
    n_levels = len(prm.get("encoder_channels", [16, 32, 64, 64]))
    dense_from = min(max(int(prm.get("dense_from_level", 2)), 1), n_levels)
    if prm.get("downsample", "dilate") != "dilate":
        raise ValueError("the reference writes the dilating downsample")
    coords, x = voxelize_mean(p, cfg)
    grid = _grid(cfg)
    pad_in = int(cfg["budget"]["max_voxels"])
    i = 0
    for level in range(dense_from):
        for _ in range(2):
            name = f"{enc}/SparseConv3D_{i}"
            kern = w[f"params/{name}/kernel"]
            y, pairs = sparse_conv(x, coords, grid, coords, 1, kern, lowp)
            if work is not None:
                work.append((len(coords), len(coords), pairs, kern.shape[1],
                             kern.shape[2], pad_in, pad_in))
            x = torch.relu(_bn(y, w, f"{name}/BatchNorm_0", 1, calibrate))
            i += 1
        if level < n_levels - 1:
            name = f"{enc}/SparseConv3D_{i}"
            kern = w[f"params/{name}/kernel"]
            budget = int(budgets[level + 1])
            out, go = strided_outputs(coords, grid, budget)
            y, pairs = sparse_conv(x, coords, grid, out, 2, kern, lowp)
            if work is not None:
                work.append((len(coords), len(out), pairs, kern.shape[1],
                             kern.shape[2], pad_in, budget))
            y = _bn(y, w, f"{name}/BatchNorm_0", 1, calibrate)
            x, coords, grid, pad_in = torch.relu(y), out, go, budget
            i += 1
    nz, ny, nx = grid
    c = x.shape[1]
    dense = torch.zeros((1, c, nz * ny * nx), device=p.device)
    lin = _lin(coords[:, 0], coords[:, 1], coords[:, 2], grid)
    dense[0, :, lin] = x.T
    dense = dense.view(1, c, nz, ny, nx)
    active = torch.zeros((1, 1, nz * ny * nx), device=p.device)
    active[0, 0, lin] = 1.0
    active = active.view(1, 1, nz, ny, nx)
    strides = []
    for level in range(dense_from, n_levels):
        strides += ([2] if level > dense_from else []) + [1, 1]
    for j, stride in enumerate(strides):
        kern = w[f"params/{enc}/Conv_{j}/kernel"]         # (3,3,3,in,out)
        h = F.conv3d(lowp(dense), lowp(kern.permute(4, 3, 0, 1, 2)),
                     stride=stride, padding=1)
        if stride == 2:
            # The cells under some tap of an active cell.
            active = F.max_pool3d(active, 3, stride=2, padding=1)
        h = _bn(h, w, f"{enc}/MaskedBatchNorm_{j}", 1, calibrate,
                active.bool().expand_as(h))
        dense = torch.relu(h) * active
    _, c, nz, ny, nx = dense.shape
    return dense.permute(0, 2, 1, 3, 4).reshape(nz * c, ny, nx)


def forward(points: torch.Tensor, counts: torch.Tensor, w: Dict,
            cfg: Dict, lowp: Cast = _same, calibrate: bool = False
            ) -> Dict[str, torch.Tensor]:
    """Per-anchor logits and residuals of a batch of clouds; with
    ``calibrate`` (one cloud) every BatchNorm's running statistics are
    set to its input's on the way."""
    prm = cfg["model"]["params"]
    bev = torch.stack([encoder(points[i, :int(counts[i])], w, cfg, lowp,
                               calibrate=calibrate)
                       for i in range(points.shape[0])])
    x = backbone(bev, w, prm.get("bev_layers", [5, 5]),
                 prm.get("bev_strides", [1, 2]),
                 prm.get("bev_up_strides", [1, 2]), lowp,
                 calibrate=calibrate)
    return head(x, w, len(cfg["data"]["class_names"]), lowp)


def output_stride(cfg: Dict) -> int:
    return 8


def layer_work(points: torch.Tensor, counts: torch.Tensor, w: Dict,
               cfg: Dict) -> List[List[Tuple]]:
    """Each cloud's sparse convs: (rows in, rows out, pairs, C in, C out,
    list size in, list size out)."""
    out = []
    for i in range(points.shape[0]):
        work: List = []
        encoder(points[i, :int(counts[i])], w, cfg, work=work)
        out.append(work)
    return out
