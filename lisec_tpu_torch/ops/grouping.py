"""Grouping and gathers (port of ``lisec_tpu/ops/grouping.py``).

Every gather goes through :class:`~lisec_tpu_torch.ops.cuda.gather_rows.
GatherRows`, and the grouping through its ``GroupAndDecorate``: the
hand-written gather and grouping kernels on a CUDA tensor (their
backward the ordered scatter kernel), the plain versions on a CPU
tensor. The JAX package's table-size limit and its fallback off the TPU
are devices of that machine and are not carried over.
"""

from __future__ import annotations

from typing import Optional

import torch

from lisec_tpu_torch.ops.cuda import gather_rows as rows


def _as_batch(t: torch.Tensor, *tail: int) -> torch.Tensor:
    """``t`` as a contiguous (B, *tail) tensor, its leading dims folded
    into B (no reshape where it is one already: the small gathers of a
    predict are held by the host, a microsecond a call)."""
    if t.dim() != 1 + len(tail):
        t = t.reshape(-1, *tail)
    return t.contiguous()


def _differentiated(*tensors) -> bool:
    """Whether autograd must see the call: the ``autograd.Function`` costs
    the host several microseconds a call, so a call no gradient flows
    through goes to the wrapper directly."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _gather(features: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """(..., N, C) x (..., M') int -> (..., M', C)."""
    lead = features.shape[:-2]
    n, c = features.shape[-2:]
    src = _as_batch(features, n, c)
    idx = _as_batch(flat_idx.to(torch.int32), flat_idx.shape[-1])
    out = (rows.GatherRows.apply(src, idx) if _differentiated(src)
           else rows.gather_rows(src, idx))
    return out if len(lead) == 1 else out.reshape(*lead, -1, c)


def gather_points(points: torch.Tensor, indices: torch.Tensor
                  ) -> torch.Tensor:
    """Gather rows: points (..., N, C), indices (..., M) -> (..., M, C);
    the gather kernel on a CUDA tensor, its plain version on a CPU one."""
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
    centers_xyz (..., M, 3), indices (..., M, K) -> (..., M, K, 3 + C).
    One launch of the grouping kernel on the card (the gathers, the
    subtraction and the concatenation together); its backward scatters
    the features' gradient, and xyz's and the centres' where they need
    one."""
    lead = indices.shape[:-2]
    m, k = indices.shape[-2:]
    n = xyz.shape[-2]
    args = (_as_batch(xyz, n, 3),
            None if features is None
            else _as_batch(features, n, features.shape[-1]),
            _as_batch(centers_xyz, m, 3),
            _as_batch(indices.to(torch.int32), m, k))
    out = (rows.GroupAndDecorate.apply(*args) if _differentiated(*args[:3])
           else rows.group_and_decorate(*args))
    return out if len(lead) == 1 else out.reshape(*lead, m, k,
                                                  out.shape[-1])
