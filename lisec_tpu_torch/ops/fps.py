"""Farthest-point sampling (port of ``lisec_tpu/ops/fps.py``).

M sequential rounds of a running min-distance update and an argmax,
seeded by the first valid point, the lowest index winning every tie;
masked points are never picked. On a CUDA tensor this always launches
the hand-written kernel (``ops/cuda/fps.py``); on a CPU tensor it runs
that kernel's plain version, which repeats the JAX package's arithmetic.
"""

from __future__ import annotations

import torch

from lisec_tpu_torch.ops.cuda.fps import fps


def farthest_point_sampling(points: torch.Tensor, point_mask: torch.Tensor,
                            num_samples: int) -> torch.Tensor:
    """(..., M) int32 indices into N of points (..., N, 3) under the mask
    (..., N). If fewer than M points are valid, the remaining picks
    repeat already-chosen valid indices."""
    lead, n = points.shape[:-2], points.shape[-2]
    flat = points.reshape(-1, n, 3).float().contiguous()
    mask = point_mask.reshape(-1, n).bool().contiguous()
    return fps(flat, mask, num_samples).reshape(*lead, num_samples)
