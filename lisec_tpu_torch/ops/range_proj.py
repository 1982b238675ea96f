"""Spherical range projection (port of ``lisec_tpu/ops/range_proj.py``).

``range_project`` is the single-cloud z-buffer written as two scatters
(per-pixel minimum range, then the lowest point index among the range
winners), kept as the oracle. ``range_project_batch`` is the main path:
one stable sort of the points by (pixel, range), which starts from the
index order and so breaks the remaining ties by the lower index, puts
each pixel's winner first in its run; one sum-only ``segment_paint`` of
the winner rows (every other row's values are zero) then writes the
image. The paint is exact f32, so the winner's index rides one channel;
the JAX package splits it in two because its paint routes values
through bf16. The rows stay 8 channels wide, which the kernel stores as
16-byte vectors.

The pixel of a point follows the JAX package's jitted CPU program bit
for bit (``tests/test_torch_rangeseg.py`` holds points on pixel edges
against it), which differs from the plain formula in three places:

* XLA expands ``asin(q)`` into ``2 atan2(q, 1 + sqrt((1 - q)(1 + q)))``;
* it turns ``yaw / pi`` into a product with the f32 reciprocal and fuses
  ``1 - yaw * (1 / pi)`` into one multiply-add (here: in f64, rounded
  once);
* it calls the C library's ``atan2f`` and takes an IEEE square root.
  On the CPU torch's f32 ``atan2`` takes SLEEF's vectorised version on
  contiguous operands and ``atan2f`` element by element on strided ones,
  so its operands are handed over as strided views, and the square root
  is taken in f64 and rounded once (which is IEEE's f32 square root).

On the card the same formulas run with CUDA's ``atan2f``, which may move
a point on a pixel edge by one pixel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lisec_tpu_torch.ops.cuda.segment_paint import segment_paint


class RangeImage(NamedTuple):
    """image (..., H, W, 5): range, x, y, z, remission of each pixel's
    winner, 0 where empty; image_mask (..., H, W) bool; pixel_uv (..., N,
    2) int32 (v, u) per point (clamped); point_range (..., N) f32;
    winner_idx (..., H, W) int32 point index per pixel (N where empty);
    pixel_pix (..., N) int32 flat pixel id ``v * W + u`` (clamped)."""

    image: torch.Tensor
    image_mask: torch.Tensor
    pixel_uv: torch.Tensor
    point_range: torch.Tensor
    winner_idx: torch.Tensor
    pixel_pix: torch.Tensor


def _atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f32 ``atan2`` on strided operands (see the module docstring)."""
    pair = torch.stack([y, x], dim=-1)
    return torch.atan2(pair[..., 0], pair[..., 1])


def _pixels(xyz: torch.Tensor, height: int, width: int, fov_up_deg: float,
            fov_down_deg: float):
    """(range, v, u) of points (..., 3): f32 and two int32 clamped to the
    image."""
    r = torch.linalg.norm(xyz, dim=-1)
    yaw = _atan2(xyz[..., 1], xyz[..., 0])
    q = (xyz[..., 2] / r.clamp_min(1e-6)).clamp(-1.0, 1.0)
    root = torch.sqrt(((1.0 - q) * (q + 1.0)).double()).float()
    pitch = 2.0 * _atan2(q, root + 1.0)

    deg = np.float32(np.pi / 180)
    fov_up = np.float32(fov_up_deg) * deg
    fov_down = np.float32(fov_down_deg) * deg
    fov = float(fov_up - fov_down)
    inv_pi = float(np.float32(1 / np.pi))
    u = 0.5 * (1.0 - yaw.double() * inv_pi).float() * width
    v = (1.0 - (pitch - float(fov_down)) / fov) * height
    u = u.floor().clamp(0, width - 1).to(torch.int32)
    v = v.floor().clamp(0, height - 1).to(torch.int32)
    return r, v, u


def _remission(points: torch.Tensor) -> torch.Tensor:
    if points.shape[-1] > 3:
        return points[..., 3]
    return points.new_zeros(points.shape[:-1])


def range_project(points: torch.Tensor, point_mask: torch.Tensor, *,
                  height: int = 64, width: int = 2048,
                  fov_up_deg: float = 3.0, fov_down_deg: float = -25.0
                  ) -> RangeImage:
    """Project one padded cloud (N, >=4: x, y, z, remission) to a range
    image by two scatter minima (the oracle of
    :func:`range_project_batch`)."""
    n = points.shape[0]
    xyz = points[:, :3]
    mask = point_mask.bool()
    r, v, u = _pixels(xyz, height, width, fov_up_deg, fov_down_deg)
    hw = height * width
    pix = v * width + u
    pix_valid = torch.where(mask, pix, hw).long()

    big = torch.finfo(r.dtype).max
    # Pass 1: per-pixel min range.
    zmin = r.new_full((hw + 1,), big).scatter_reduce(
        0, pix_valid, torch.where(mask, r, big), "amin")
    # Pass 2: lowest point index among range winners (unique writer).
    is_winner = mask & (r <= zmin[pix_valid])
    idx = torch.arange(n, dtype=torch.int32, device=points.device)
    widx = torch.full((hw + 1,), n, dtype=torch.int32,
                      device=points.device).scatter_reduce(
        0, torch.where(is_winner, pix_valid, hw), idx, "amin")
    winner = widx[:hw]

    feats = torch.cat([r[:, None], xyz, _remission(points)[:, None]], -1)
    feats_pad = torch.cat([feats, feats.new_zeros((1, 5))])
    image_mask = (winner < n).view(height, width)
    image = feats_pad[winner.clamp(max=n).long()].view(height, width, 5)
    image = torch.where(image_mask[..., None], image, 0.0)
    return RangeImage(image=image, image_mask=image_mask,
                      pixel_uv=torch.stack([v, u], -1), point_range=r,
                      winner_idx=winner.view(height, width), pixel_pix=pix)


def range_unproject(pixel_values: torch.Tensor, pixel_uv: torch.Tensor
                    ) -> torch.Tensor:
    """Read back per-point values from a (H, W, ...) image at (v, u)."""
    return pixel_values[pixel_uv[:, 0].long(), pixel_uv[:, 1].long()]


def range_project_batch(points: torch.Tensor, point_mask: torch.Tensor, *,
                        height: int = 64, width: int = 2048,
                        fov_up_deg: float = 3.0, fov_down_deg: float = -25.0
                        ) -> RangeImage:
    """Project padded clouds (B, N, >=4) on the sort and paint path; the
    same function as ``range_project`` on each cloud."""
    b, n = points.shape[:2]
    dev = points.device
    xyz = points[..., :3]
    mask = point_mask.bool()
    r, v, u = _pixels(xyz, height, width, fov_up_deg, fov_down_deg)
    hw = height * width
    pix = v * width + u
    pix_masked = torch.where(mask, pix, hw)

    # One stable sort by (pixel, range): a range is >= 0, so its f32 bits
    # order as its value and fill the key's low word. Masked points sort
    # to the end at pixel hw, which the paint drops.
    key = (pix_masked.long() << 32) | r.view(torch.int32).long()
    order = torch.sort(key, dim=1, stable=True).indices
    pix_s = pix_masked.gather(1, order)
    prev = torch.cat([pix_s.new_full((b, 1), -1), pix_s[:, :-1]], 1)
    start = (pix_s != prev) & (pix_s < hw)

    # Winner rows: range, x, y, z, remission, index + 1, two zeros; every
    # other row zero, so each pixel's sum is its winner's row.
    idx1 = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    zero = r.new_zeros(b, n)
    rows = torch.stack([r, xyz[..., 0], xyz[..., 1], xyz[..., 2],
                        _remission(points), idx1.expand(b, n), zero, zero],
                       dim=-1)
    vals = rows.gather(1, order[..., None].expand(-1, -1, 8)) \
        * start[..., None]
    tab = segment_paint(vals, pix_s.contiguous(), num_cells=hw, num_max=0)

    occupied = tab[..., 5] > 0.0
    winner = torch.where(occupied, tab[..., 5].to(torch.int32) - 1, n)
    return RangeImage(
        image=tab[..., :5].view(b, height, width, 5),
        image_mask=occupied.view(b, height, width),
        pixel_uv=torch.stack([v, u], -1), point_range=r,
        winner_idx=winner.view(b, height, width), pixel_pix=pix)
