"""Point-axis sharding of one large cloud across ranks (port of
``lisec_tpu/parallel/point_sharded.py``): farthest-point sampling and
ball query when one scene's points are split over the ranks of a mesh.

Rank r holds the contiguous slice ``[r n, (r + 1) n)`` of the cloud's N
= W n points. Both functions return, on every rank, exactly the indices
of the single-device ops (``ops.fps.farthest_point_sampling`` and
``ops.ball_query.ball_query``): the lowest index wins every tie and
masked points are never picked. They are plain PyTorch around
collectives, as the JAX versions are ``jnp`` under ``shard_map``; no
kernel of the port runs here.
"""

from __future__ import annotations

import torch

from lisec_tpu_torch.ops.ball_query import in_radius
from lisec_tpu_torch.ops.cuda.fps import _NEG
from lisec_tpu_torch.parallel.mesh import Mesh, all_gather, use_mesh

_LOW = (1 << 32) - 1


def _key(dist: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """One int64 per point, ordered as (distance, -global index): the
    f32 bits made monotone in the high word, ``2^32 - 1 - index`` in the
    low word, so the largest key is the farthest point with the lowest
    index."""
    bits = dist.view(torch.int32).to(torch.int64)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return bits * (1 << 32) + (_LOW - gidx)


def fps_sharded(points: torch.Tensor, point_mask: torch.Tensor,
                num_samples: int, mesh: Mesh) -> torch.Tensor:
    """(M,) int32 global indices of farthest-point sampling over the
    whole cloud; ``points`` (n, 3) f32 and ``point_mask`` (n,) are this
    rank's slice. Each round is one ``all_reduce``: every rank's best
    (key, x, y, z), as int64 words, gathered by a SUM into a zero
    buffer; the largest key wins and its coordinates come with it. The
    distances are the single-device op's arithmetic."""
    n = points.shape[0]
    dev = points.device
    mask = point_mask.bool()
    gidx = mesh.rank * n + torch.arange(n, device=dev)
    xs, ys, zs = points.float().unbind(-1)
    coords = points.float().contiguous().view(torch.int32).to(torch.int64)
    out = torch.empty(num_samples, dtype=torch.int32, device=dev)

    def pick(dist):
        """(global index, xyz) of the farthest point over the ranks."""
        keys = _key(dist, gidx)
        i = keys.argmax()
        mine = torch.cat([keys[i, None], coords[i]])[None]     # (1, 4)
        with use_mesh(mesh):
            every = all_gather(mine)                            # (W, 4)
        best = every[every[:, 0].argmax()]
        win = _LOW - (best[0] & _LOW)
        return win, best[1:].to(torch.int32).view(torch.float32)

    # The seed is the first valid point: the lowest index at the largest
    # starting distance (index 0 when no point is valid).
    dist = torch.where(mask, 3.0e38, _NEG)
    win, c = pick(dist)
    out[0] = win
    for i in range(1, num_samples):
        dx, dy, dz = xs - c[0], ys - c[1], zs - c[2]
        d2 = (dx * dx + dy * dy) + dz * dz
        dist = torch.minimum(dist, torch.where(mask, d2, _NEG))
        win, c = pick(dist)
        out[i] = win
    return out


def ball_query_sharded(centers: torch.Tensor, points: torch.Tensor,
                       point_mask: torch.Tensor, *, radius: float,
                       num_neighbors: int, mesh: Mesh) -> torch.Tensor:
    """(M, K) int32 global indices of the first K points within
    ``radius`` of each centre, in index order, empty slots repeating the
    first found (or 0). ``centers`` (M, 3) are the same on every rank;
    ``points`` (n, 3) and ``point_mask`` (n,) are this rank's slice.
    Each rank keeps its first K in-radius indices; the lists, gathered
    in rank order, are in global index order, so their first K are the
    answer. The payload is (M, W K) indices, not the (M, N) distances."""
    n = points.shape[0]
    total = n * mesh.world
    k = num_neighbors
    gidx = (mesh.rank * n
            + torch.arange(n, dtype=torch.int32, device=points.device))
    inside = in_radius(centers, points, point_mask, radius)      # (M, n)
    key = torch.where(inside, gidx, total)
    local = torch.topk(key, min(k, n), dim=-1, largest=False,
                       sorted=True).values
    if local.shape[1] < k:
        local = torch.cat([local, local.new_full(
            (len(local), k - local.shape[1]), total)], 1)
    with use_mesh(mesh):
        every = all_gather(local)                               # (W M, K)
    every = every.view(mesh.world, -1, k).transpose(0, 1)
    every = every.reshape(-1, mesh.world * k)
    knn = torch.topk(every, k, dim=-1, largest=False, sorted=True).values
    first = torch.where(knn[:, :1] < total, knn[:, :1], 0)
    return torch.where(knn < total, knn, first).to(torch.int32)
