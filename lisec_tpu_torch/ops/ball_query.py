"""Ball query (port of ``lisec_tpu/ops/ball_query.py``).

Plain PyTorch, as the reference is XLA code: the squared distances
through ``|c|^2 - 2 c.p + |p|^2`` (the cross term one matrix product),
in-radius points keep their index as key and the others get N, the K
smallest keys are the first K in-radius indices in index order (an
exact top-k; the TPU's ``approx_max_k`` is not carried over), and empty
slots repeat the first index found, or 0.
"""

from __future__ import annotations

import torch


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """``x.x`` over the last axis of 3, summed in index order."""
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) \
        + x[..., 2] * x[..., 2]


def in_radius(centers: torch.Tensor, points: torch.Tensor,
              point_mask: torch.Tensor, radius: float) -> torch.Tensor:
    """(..., M, N) bool: point n is valid and its squared distance to
    centre m is below ``radius**2``."""
    cross = centers @ points.transpose(-1, -2)                # (..., M, N)
    d2 = (_sq_norm(centers)[..., :, None] - 2.0 * cross
          + _sq_norm(points)[..., None, :])
    return (d2 < radius * radius) & point_mask.bool()[..., None, :]


def ball_query(centers: torch.Tensor, points: torch.Tensor,
               point_mask: torch.Tensor, *, radius: float,
               num_neighbors: int) -> torch.Tensor:
    """centers (..., M, 3), points (..., N, 3), point_mask (..., N) ->
    (..., M, K) int32 indices of up to K points with squared distance
    below ``radius**2``; a centre with none returns index 0."""
    n = points.shape[-2]
    inside = in_radius(centers, points, point_mask, radius)
    idx = torch.arange(n, dtype=torch.int32, device=points.device)
    key = torch.where(inside, idx, n)
    knn = torch.topk(key, num_neighbors, dim=-1, largest=False,
                     sorted=True).values
    first = torch.where(knn[..., :1] < n, knn[..., :1], 0)
    return torch.where(knn < n, knn, first).to(torch.int32)
