"""Box coding and BEV corners (port of ``lisec_tpu/ops/boxes.py``).

7-DoF boxes ``(x, y, z, l, w, h, yaw)`` with (x, y, z) the box centre,
l along the heading and yaw about +z from +x; residuals follow the
diagonal-normalised SECOND/PointPillars coding.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Residual-encode target boxes against anchors, both (..., 7).

    (dx, dy) are normalised by the anchor's BEV diagonal, dz by its
    height, sizes by log-ratio, the angle as a plain residual (the
    sin-difference trick lives in the loss). The JAX package also has
    this function on channel-leading columns, a tiling device of its
    machine; one row form serves here."""
    xa, ya, za, la, wa, ha, ra = anchors.unbind(-1)
    xg, yg, zg, lg, wg, hg, rg = boxes.unbind(-1)
    diag = torch.sqrt(la * la + wa * wa) + _EPS
    return torch.stack([
        (xg - xa) / diag,
        (yg - ya) / diag,
        (zg - za) / (ha + _EPS),
        torch.log(lg / (la + _EPS) + _EPS),
        torch.log(wg / (wa + _EPS) + _EPS),
        torch.log(hg / (ha + _EPS) + _EPS),
        rg - ra,
    ], dim=-1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Residuals (..., 7) against anchors (..., 7) -> boxes (..., 7)."""
    xa, ya, za, la, wa, ha, ra = anchors.unbind(-1)
    tx, ty, tz, tl, tw, th, tr = deltas.unbind(-1)
    # Clamp size residuals so untrained or garbage logits cannot decode
    # to inf-sized boxes (exp overflow) downstream in NMS.
    tl, tw, th = (t.clamp(-10.0, 4.0) for t in (tl, tw, th))
    diag = torch.sqrt(la * la + wa * wa)
    return torch.stack([
        tx * diag + xa,
        ty * diag + ya,
        tz * ha + za,
        torch.exp(tl) * la,
        torch.exp(tw) * wa,
        torch.exp(th) * ha,
        tr + ra,
    ], dim=-1)


def boxes_to_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """BEV corners of yawed boxes: (..., 7) -> (..., 4, 2), counter-
    clockwise from front-left in the box frame: (+l/2, +w/2),
    (-l/2, +w/2), (-l/2, -w/2), (+l/2, -w/2)."""
    x, y = boxes[..., 0], boxes[..., 1]
    l, w = boxes[..., 3], boxes[..., 4]
    yaw = boxes[..., 6]
    dx = torch.stack([l / 2, -l / 2, -l / 2, l / 2], dim=-1)
    dy = torch.stack([w / 2, w / 2, -w / 2, -w / 2], dim=-1)
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    cx = x[..., None] + dx * c - dy * s
    cy = y[..., None] + dx * s + dy * c
    return torch.stack([cx, cy], dim=-1)


def points_in_rbbox(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Membership of points in rotated 3D boxes: points (N, >=3), boxes
    (B, 7) -> (N, B) bool. Points on the boundary count as inside (<= on
    the half-extents). The JAX package exports it and runs it on no
    path; so does the port, for the same API (the augmentation's
    membership is ``native.points_in_rbbox_first``)."""
    xyz = points[:, None, :3] - boxes[None, :, :3]              # (N, B, 3)
    yaw = boxes[None, :, 6]
    c, s = torch.cos(yaw), torch.sin(yaw)
    # Rotate into the box frame (the inverse rotation).
    local_x = xyz[..., 0] * c + xyz[..., 1] * s
    local_y = -xyz[..., 0] * s + xyz[..., 1] * c
    local_z = xyz[..., 2]
    l, w, h = boxes[None, :, 3], boxes[None, :, 4], boxes[None, :, 5]
    return ((local_x.abs() <= l / 2) & (local_y.abs() <= w / 2)
            & (local_z.abs() <= h / 2))
