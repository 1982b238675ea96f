"""3-NN search and inverse-distance interpolation (port of
``lisec_tpu/ops/three_nn.py``), for PointNet++ feature propagation.

The distance matrix and its top-3 are plain PyTorch, as the reference is
XLA code; the top-3 is the port's stable sort (``ops/nms.py::top_k``), so
equal distances keep the lower index first, as ``lax.top_k`` does. The
interpolation gathers through :func:`~lisec_tpu_torch.ops.grouping.
group_points` (the gather kernel on the card).
"""

from __future__ import annotations

from typing import Tuple

import torch

from lisec_tpu_torch.ops.grouping import group_points
from lisec_tpu_torch.ops.nms import top_k

_EPS = 1e-8


def three_nn(query_xyz: torch.Tensor, source_xyz: torch.Tensor,
             source_mask: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each query point its 3 nearest valid source points: query
    (..., N, 3), source (..., S, 3), mask (..., S) -> (dist2 (..., N, 3),
    idx (..., N, 3) int32). Masked sources sit at the largest f32."""
    diff = query_xyz[..., :, None, :] - source_xyz[..., None, :, :]
    sq = diff * diff
    d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]              # (..., N, S)
    big = torch.finfo(d2.dtype).max
    d2 = torch.where(source_mask.bool()[..., None, :], d2, big)
    neg, idx = top_k(-d2, 3)
    return -neg, idx.to(torch.int32)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      dist2: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weighted mean of source features (..., S, C) at
    idx / dist2 (..., N, 3) -> (..., N, C)."""
    w = 1.0 / (dist2 + _EPS)
    w = w / w.sum(dim=-1, keepdim=True)
    gathered = group_points(features, idx)                   # (..., N, 3, C)
    return (gathered * w[..., None]).sum(dim=-2)
