"""Voxelization into fixed budgets (port of ``lisec_tpu/ops/voxelize.py``).

Sort-then-spread: the points are sorted by (cell id, point index), so
binning is deterministic and overflow beyond either budget drops
reproducibly. Voxel order is ascending cell id; points beyond K per cell
drop in point-index order; cells beyond P drop in cell-id order; empty
rows carry coords -1. Both voxelizers fill their tables with the paint
kernel (``lisec_tpu_torch/ops/cuda/segment_paint.py``), whose sums are
exact placements here. The JAX package's 8- and 16-lane records, its
packing of slots into 128-lane rows and its one-hot outer product serve
the TPU's paint kernel and are not carried over.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from lisec_tpu_torch.ops.cuda.segment_paint import segment_paint


class VoxelizationResult(NamedTuple):
    """voxels (B, P, K, C) zero padded; coords (B, P, 3) int32 [z, y, x],
    -1 where invalid; num_points (B, P) int32; num_voxels (B,) int32;
    point_voxel (B, N) int32 voxel of each point in the original order,
    -1 if it was dropped."""

    voxels: torch.Tensor
    coords: torch.Tensor
    num_points: torch.Tensor
    num_voxels: torch.Tensor
    point_voxel: torch.Tensor


class VoxelizeMeanResult(NamedTuple):
    """feats (B, P, C) per-voxel mean of the <= K kept points; coords
    (B, P, 3) int32 [z, y, x], -1 where invalid; num_points (B, P) int32;
    num_voxels (B,) int32."""

    feats: torch.Tensor
    coords: torch.Tensor
    num_points: torch.Tensor
    num_voxels: torch.Tensor


def point_cell_ids(points: torch.Tensor, point_mask: torch.Tensor,
                   pc_range: Sequence[float], voxel_size: Sequence[float],
                   grid_size: Tuple[int, int, int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cell id (..., N) int32, in_range (..., N) bool); the id is
    ``(iz * ny + iy) * nx + ix``, and ``nx * ny * nz`` for a masked or
    out-of-range point.

    Same f32 arithmetic as the JAX function inside the JAX package's
    jitted voxelizers: XLA rewrites the division by the constant voxel
    size into a multiply by its f32 reciprocal, so this multiplies too (a
    true division moves points that lie exactly on cell edges)."""
    nx, ny, nz = grid_size
    idx = []
    for axis, size in enumerate((nx, ny, nz)):
        inv = float(np.float32(1.0) / np.float32(voxel_size[axis]))
        # Clamp before the int cast so far-away points cannot overflow
        # it; the clamp keeps them out of range.
        f = torch.floor((points[..., axis] - pc_range[axis]) * inv)
        idx.append(f.clamp(-1, size).to(torch.int32))
    ix, iy, iz = idx
    in_range = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
                & (iz >= 0) & (iz < nz) & point_mask.to(torch.bool))
    cell = (iz * ny + iy) * nx + ix
    return torch.where(in_range, cell,
                       torch.full_like(cell, nx * ny * nz)), in_range


class _Binned(NamedTuple):
    order: torch.Tensor        # (B, N) int64: sorted position -> point
    pts: torch.Tensor          # (B, N, C) f32 points in sorted order
    is_start: torch.Tensor     # (B, N) bool: first point of a valid cell
    rank: torch.Tensor         # (B, N) int32 voxel rank of the point
    within: torch.Tensor       # (B, N) int32 position within its cell
    in_list: torch.Tensor      # (B, N) bool: in range, in a cell < P
    keep: torch.Tensor         # (B, N) bool: in_list and among K per cell
    coords1: torch.Tensor      # (B, N, 3) f32 [z, y, x] + 1
    num_voxels: torch.Tensor   # (B,) int32


def _bin_points(points, point_mask, pc_range, voxel_size, grid_size,
                max_voxels, max_points_per_voxel) -> _Binned:
    b, n, c = points.shape
    nx, ny, nz = grid_size
    num_cells = nx * ny * nz
    cell, _ = point_cell_ids(points, point_mask, pc_range, voxel_size,
                             grid_size)
    # A stable sort on the cell id is the (cell, point index) order.
    cell_s, order = torch.sort(cell, dim=1, stable=True)
    pts = torch.gather(points.float(), 1, order[..., None].expand(-1, -1, c))
    valid = cell_s < num_cells
    prev = torch.cat([cell_s.new_full((b, 1), -1), cell_s[:, :-1]], dim=1)
    is_start = (cell_s != prev) & valid
    rank = (torch.cumsum(is_start, dim=1) - 1).to(torch.int32)
    total = torch.where(valid.any(dim=1), rank[:, -1] + 1,
                        torch.zeros_like(rank[:, -1]))
    pos = torch.arange(n, dtype=torch.int32, device=points.device)
    seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=1).values
    within = pos - seg_start
    in_list = valid & (rank < max_voxels)
    keep = in_list & (within < max_points_per_voxel)
    clip = cell_s.clamp(max=num_cells - 1)
    coords1 = torch.stack([
        torch.div(clip, nx * ny, rounding_mode="floor"),
        torch.div(clip, nx, rounding_mode="floor") % ny,
        clip % nx], dim=-1).float() + 1.0
    return _Binned(order, pts, is_start, rank, within, in_list, keep, coords1,
                   total.clamp(max=max_voxels).to(torch.int32))


def voxelize_batch(points: torch.Tensor, point_mask: torch.Tensor, *,
                   pc_range: Sequence[float], voxel_size: Sequence[float],
                   grid_size: Tuple[int, int, int], max_voxels: int,
                   max_points_per_voxel: int) -> VoxelizationResult:
    """Deterministic fixed-budget voxelization of a batch of clouds:
    points (B, N, C) whose first three channels are x, y, z, and a
    (B, N) valid-point mask."""
    b, n, c = points.shape
    kk = max_points_per_voxel
    bins = _bin_points(points, point_mask, pc_range, voxel_size, grid_size,
                       max_voxels, kk)
    # Every kept point owns slot rank * K + within, strictly increasing.
    # A point beyond K keeps the stream ascending with a zero record on
    # its cell's last slot; cells beyond P and invalid points sort last
    # and go to the sentinel row.
    ones = torch.ones((b, n, 1), device=points.device)
    rec = torch.cat([bins.pts, ones, bins.coords1], dim=-1)
    rec = torch.where(bins.keep[..., None], rec, 0.0)
    slot = torch.where(bins.in_list,
                       bins.rank * kk + bins.within.clamp(max=kk - 1),
                       max_voxels * kk)
    table = segment_paint(rec, slot, num_cells=max_voxels * kk, num_max=0)
    table = table.view(b, max_voxels, kk, c + 4)

    voxels = table[..., :c].to(points.dtype)
    num_points = table[..., c].sum(dim=-1).round().to(torch.int32)
    # Slot 0 is filled for every non-empty voxel; an empty one reads -1.
    coords = (table[:, :, 0, c + 1:] - 1.0).to(torch.int32)
    pv_sorted = torch.where(bins.keep, bins.rank, -1)
    point_voxel = torch.empty_like(pv_sorted).scatter_(1, bins.order,
                                                       pv_sorted)
    return VoxelizationResult(voxels, coords, num_points, bins.num_voxels,
                              point_voxel)


def voxelize_mean_batch(points: torch.Tensor, point_mask: torch.Tensor, *,
                        pc_range: Sequence[float],
                        voxel_size: Sequence[float],
                        grid_size: Tuple[int, int, int], max_voxels: int,
                        max_points_per_voxel: int) -> VoxelizeMeanResult:
    """Voxelize and take each voxel's mean in one paint, never making the
    (P, K, C) table: exactly ``mean_vfe(voxelize_batch(...))``, the mean
    being over the first K points of a cell in point-index order."""
    b, n, c = points.shape
    bins = _bin_points(points, point_mask, pc_range, voxel_size, grid_size,
                       max_voxels, max_points_per_voxel)
    # The record sums to [sum of points | count | coords + 1]: the coords
    # ride on the cell's first point only.
    ones = torch.ones((b, n, 1), device=points.device)
    rec = torch.cat([bins.pts, ones,
                     bins.coords1 * bins.is_start[..., None]], dim=-1)
    rec = torch.where(bins.keep[..., None], rec, 0.0)
    # Points beyond K keep their rank with a zero record; cells beyond P
    # and invalid points sort last and go to the sentinel row.
    stream = torch.where(bins.in_list, bins.rank, max_voxels)
    table = segment_paint(rec, stream, num_cells=max_voxels, num_max=0)

    cnt = table[..., c]
    feats = (table[..., :c] / cnt.clamp_min(1.0)[..., None]).to(points.dtype)
    coords = (table[..., c + 1:].round() - 1.0).to(torch.int32)
    return VoxelizeMeanResult(feats, coords, cnt.round().to(torch.int32),
                              bins.num_voxels)


def voxelize(points: torch.Tensor, point_mask: torch.Tensor, *,
             pc_range: Sequence[float], voxel_size: Sequence[float],
             grid_size: Tuple[int, int, int], max_voxels: int,
             max_points_per_voxel: int) -> VoxelizationResult:
    """Single-cloud :func:`voxelize_batch`: points (N, C), mask (N,)."""
    out = voxelize_batch(
        points[None], point_mask[None], pc_range=pc_range,
        voxel_size=voxel_size, grid_size=grid_size, max_voxels=max_voxels,
        max_points_per_voxel=max_points_per_voxel)
    return VoxelizationResult(*(x[0] for x in out))
