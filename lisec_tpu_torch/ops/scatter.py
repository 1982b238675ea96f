"""Differentiable sorted segment reductions (port of ``segment_max_sorted``
and ``segment_sum_dense`` from ``lisec_tpu/ops/scatter.py``).

Both run the paint kernel forward and a kernel of the unpaint source
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
