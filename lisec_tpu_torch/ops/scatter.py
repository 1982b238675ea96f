"""Pillar scatters and differentiable sorted segment reductions (port of
``lisec_tpu/ops/scatter.py``).

``pillar_scatter`` and ``pillar_scatter_max`` are XLA scatters in the
JAX package, not Pallas kernels, so they are plain PyTorch here: an
``index_copy`` and a ``scatter_reduce`` onto a table with a trash row
that is sliced off, with the JAX ``mode="drop"`` semantics. The
scatter's gradient is autograd's gather of the canvas cotangent.

``segment_max_sorted`` and ``segment_sum_dense``
run the paint kernel forward and a kernel of the unpaint source
backward (``lisec_tpu_torch/ops/cuda/segment_paint.py``,
``segment_unpaint.py``; on CPU tensors those wrappers compute their
plain versions): the segment max's whole backward is one
``segment_max_backward`` launch, the dense sum's one gather that writes
the features' type. The backward passes are written out here, never left
to autograd of a scatter: ``scatter_reduce(..., "amax")`` would split a
cotangent evenly among tied rows, while the segment max gives the whole
cotangent to every row that equals its cell's max, as the JAX package
does. The equality is tested in exact f32 (the JAX package tests the
leading 17 mantissa bits; for bf16-valued features the two tests select
the same rows).
"""

from __future__ import annotations

from typing import Tuple

import torch

from lisec_tpu_torch.ops.cuda.segment_paint import segment_paint
from lisec_tpu_torch.ops.cuda.segment_unpaint import (
    segment_max_backward, segment_unpaint)


def _drop_to_trash(index: torch.Tensor, size: int) -> torch.Tensor:
    """Row ``index`` of a table of ``size`` rows plus a trash row, as a
    JAX ``mode="drop"`` scatter places it: a negative index counts from
    the end (so -1 is the trash row); one still outside ``[0, size]`` is
    dropped, here into the trash row."""
    index = torch.where(index < 0, index + size + 1, index)
    return torch.where((index < 0) | (index > size), size, index)


def pillar_scatter(pillar_features: torch.Tensor, coords: torch.Tensor,
                   num_voxels: torch.Tensor, *, ny: int, nx: int
                   ) -> torch.Tensor:
    """Scatter (..., P, C) pillar features to a (..., C, ny, nx) canvas
    by coords (..., P, 3) [z, y, x].

    A pillar is invalid when its rank is >= ``num_voxels`` (...,) or its
    y is negative; it writes to the trash row. Each valid pillar owns its
    cell (the voxelizer gives one pillar a cell), so the copy has no
    race. The canvas is the NCHW view of channels-last memory, as the
    backbone takes it."""
    lead, (p, c) = pillar_features.shape[:-2], pillar_features.shape[-2:]
    feats = pillar_features.reshape(-1, p, c)
    coords = coords.reshape(-1, p, 3)
    b = feats.shape[0]
    cells = ny * nx
    valid = ((torch.arange(p, device=feats.device)[None, :]
              < num_voxels.reshape(-1, 1)) & (coords[..., 1] >= 0))
    lin = coords[..., 1].long() * nx + coords[..., 2].long()
    lin = _drop_to_trash(torch.where(valid, lin, cells), cells)
    # One trash row after all clouds' cells, so that the canvas is one
    # contiguous channels-last block.
    rows = torch.where(lin == cells, b * cells, lin + torch.arange(
        b, device=feats.device)[:, None] * cells).reshape(-1)
    canvas = feats.new_zeros((b * cells + 1, c)).index_copy(
        0, rows, feats.reshape(-1, c))[:-1]
    return canvas.view(*lead, ny, nx, c).movedim(-1, -3)


def pillar_scatter_max(point_features: torch.Tensor,
                       point_voxel: torch.Tensor, *,
                       num_cells: int) -> torch.Tensor:
    """Scatter-max per-point features (N, C) into per-cell slots by
    ``point_voxel`` (N,), -1 = dropped: (num_cells, C), zeros where a
    cell is empty (every non-finite max becomes 0)."""
    idx = _drop_to_trash(
        torch.where(point_voxel >= 0, point_voxel, num_cells).long(),
        num_cells)
    c = point_features.shape[1]
    out = torch.full((num_cells + 1, c), -torch.inf,
                     dtype=point_features.dtype,
                     device=point_features.device).scatter_reduce(
        0, idx[:, None].expand(-1, c), point_features, "amax")[:-1]
    return torch.where(torch.isfinite(out), out, 0.0)


def _with_ones(h: torch.Tensor) -> torch.Tensor:
    """(B, N, C + 1) f32: the features and a channel of ones, whose
    per-cell sum is the count."""
    return torch.cat([h.float(), torch.ones_like(h[..., :1],
                                                 dtype=torch.float32)], -1)


class _SegmentMaxSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, cell_sorted, num_cells):
        c = h.shape[-1]
        canvas, count = segment_paint(_with_ones(h), cell_sorted,
                                      num_cells=num_cells, num_max=c, split=c)
        count = count[..., 0]
        ctx.save_for_backward(h, cell_sorted, canvas)
        ctx.mark_non_differentiable(count)
        return canvas, count

    @staticmethod
    def backward(ctx, g_canvas, _g_count):
        h, cell_sorted, canvas = ctx.saved_tensors
        dh = segment_max_backward(h.contiguous(), cell_sorted, canvas,
                                  g_canvas.float().contiguous())
        return dh, None, None


def segment_max_sorted(h: torch.Tensor, cell_sorted: torch.Tensor,
                       num_cells: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cell max of ascending-cell-sorted features, with a gradient.

    h: (B, N, C) per-row features (f32 or bf16), sorted by
    ``cell_sorted`` (B, N) int32 ascending; invalid ids >= num_cells.
    Returns (canvas (B, num_cells, C) f32 with -3e38 where empty, count
    (B, num_cells) f32 valid-row counts). Every row equal to its cell's
    max receives that cell's whole cotangent.
    """
    return _SegmentMaxSorted.apply(h, cell_sorted.contiguous(), num_cells)


class _SegmentSumDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, cell_sorted, num_cells):
        c = h.shape[-1]
        table, count = segment_paint(_with_ones(h), cell_sorted,
                                     num_cells=num_cells, num_max=0, split=c)
        count = count[..., 0]
        ctx.save_for_backward(cell_sorted)
        ctx.h_dtype = h.dtype
        ctx.mark_non_differentiable(count)
        return table, count

    @staticmethod
    def backward(ctx, g_table, _g_count):
        cell_sorted, = ctx.saved_tensors
        per_row = segment_unpaint(g_table.float().contiguous(), cell_sorted,
                                  out_dtype=ctx.h_dtype)
        return per_row, None, None


def segment_sum_dense(h: torch.Tensor, cell_sorted: torch.Tensor,
                      num_cells: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense per-cell sum table of ascending-cell-sorted features, with a
    gradient (the row gather of the cotangent table).

    h: (B, N, C) per-row features (f32 or bf16), sorted by
    ``cell_sorted`` (B, N) int32 ascending; invalid ids >= num_cells. With unique cells (a voxel list)
    the sum is an exact placement. Returns (table (B, num_cells, C) f32,
    zeros where empty; count (B, num_cells) f32 per-cell row counts).
    """
    return _SegmentSumDense.apply(h, cell_sorted.contiguous(), num_cells)
