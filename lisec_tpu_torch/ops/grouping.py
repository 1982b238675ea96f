"""Grouping and gathers (port of ``lisec_tpu/ops/grouping.py``).

Every gather goes through :class:`~lisec_tpu_torch.ops.cuda.gather_rows.
GatherRows`: the hand-written gather kernel on a CUDA tensor (its
backward the ordered scatter kernel), the plain versions on a CPU
tensor. The JAX package's table-size limit and its fallback off the TPU
are devices of that machine and are not carried over.
"""

from __future__ import annotations

from typing import Optional

import torch

from lisec_tpu_torch.ops.cuda.gather_rows import GatherRows


def _gather(features: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """(..., N, C) x (..., M') int -> (..., M', C)."""
    lead = features.shape[:-2]
    n, c = features.shape[-2:]
    src = features.reshape(-1, n, c).contiguous()
    idx = flat_idx.reshape(src.shape[0], -1).to(torch.int32).contiguous()
    return GatherRows.apply(src, idx).reshape(*lead, -1, c)


def gather_points(points: torch.Tensor, indices: torch.Tensor
                  ) -> torch.Tensor:
    """Gather rows: points (..., N, C), indices (..., M) -> (..., M, C)."""
    return _gather(points, indices)


def group_points(features: torch.Tensor, indices: torch.Tensor
                 ) -> torch.Tensor:
    """features (..., N, C), indices (..., M, K) -> (..., M, K, C)."""
    flat = indices.reshape(*indices.shape[:-2], -1)
    return _gather(features, flat).reshape(*indices.shape,
                                           features.shape[-1])


def group_and_decorate(xyz: torch.Tensor, features: Optional[torch.Tensor],
                       centers_xyz: torch.Tensor, indices: torch.Tensor
                       ) -> torch.Tensor:
    """Neighbourhood coordinates relative to their centre, then the
    neighbours' features: xyz (..., N, 3), features (..., N, C) or None,
    centers_xyz (..., M, 3), indices (..., M, K) -> (..., M, K, 3 + C)."""
    grouped = group_points(xyz, indices) - centers_xyz[..., None, :]
    if features is None:
        return grouped
    return torch.cat([grouped, group_points(features, indices)], dim=-1)
