"""Rotated BEV IoU (port of ``lisec_tpu/ops/rotated_iou.py``).

The intersection polygon's vertices are enumerated, not clipped: the
corners of each quad inside the other (4 + 4) and the 16 edge-pair
intersections, masked by validity, ordered by a pseudo-angle around the
valid candidates' centroid with one 24-wide sort, and integrated with
the shoelace formula. Candidate noise is O(eps), so the area's is too.
"""

from __future__ import annotations

import torch

from lisec_tpu_torch.ops.boxes import boxes_to_corners_bev

# Tolerance of the inside / intersection predicates. Pairs are recentred
# before the corners are built, so coordinates are O(box size) and f32
# cross products carry ~1e-6 of rounding noise.
_EPS = 1e-5


def _cross(o, a, b):
    """2D cross of (a - o) x (b - o) over leading batch dims."""
    return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
            - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))


def _corners_inside(pts, quad):
    """pts (..., 4, 2) inside CCW quad (..., 4, 2) -> (..., 4) bool."""
    v0 = quad[..., :, None, :]                        # (..., 4e, 1, 2)
    v1 = torch.roll(quad, -1, dims=-2)[..., :, None, :]
    p = pts[..., None, :, :]                          # (..., 1, 4p, 2)
    return (_cross(v0, v1, p) >= -_EPS).all(dim=-2)


def _edge_intersections(ca, cb):
    """The 16 segment-segment intersections of the quads' edges.

    ca, cb: (..., 4, 2) -> (pts (..., 16, 2), valid (..., 16))."""
    p1 = ca[..., :, None, :]                          # (..., 4, 1, 2)
    p2 = torch.roll(ca, -1, dims=-2)[..., :, None, :]
    q1 = cb[..., None, :, :]                          # (..., 1, 4, 2)
    q2 = torch.roll(cb, -1, dims=-2)[..., None, :, :]

    d1 = p2 - p1
    d2 = q2 - q1
    denom = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    dq = q1 - p1
    t_num = dq[..., 0] * d2[..., 1] - dq[..., 1] * d2[..., 0]
    u_num = dq[..., 0] * d1[..., 1] - dq[..., 1] * d1[..., 0]
    parallel = denom.abs() < _EPS
    safe = torch.where(parallel, torch.ones_like(denom), denom)
    t = t_num / safe
    u = u_num / safe
    valid = (~parallel & (t >= -_EPS) & (t <= 1 + _EPS)
             & (u >= -_EPS) & (u <= 1 + _EPS))
    pts = p1 + t[..., None] * d1                      # (..., 4, 4, 2)
    shape = pts.shape[:-3] + (16, 2)
    return pts.reshape(shape), valid.reshape(shape[:-1])


def _pseudo_angle(dx, dy):
    """Monotone-in-angle key in [0, 4) with one division."""
    r = dx / (dx.abs() + dy.abs()).clamp_min(_EPS)
    return torch.where(dy >= 0.0, 1.0 - r, 3.0 + r)


def _quad_intersection_area(ca, cb):
    """Intersection area of CCW quads: ca, cb (..., 4, 2) -> (...,)."""
    in_ab = _corners_inside(ca, cb)
    in_ba = _corners_inside(cb, ca)
    inter_pts, inter_ok = _edge_intersections(ca, cb)

    cand = torch.cat([ca, cb, inter_pts], dim=-2)     # (..., 24, 2)
    valid = torch.cat([in_ab, in_ba, inter_ok], dim=-1)

    k = valid.sum(dim=-1)                             # (...,)
    vf = valid[..., None].to(cand.dtype)
    centroid = ((cand * vf).sum(dim=-2)
                / k.clamp_min(1)[..., None].to(cand.dtype))

    rel = cand - centroid[..., None, :]
    ang = _pseudo_angle(rel[..., 0], rel[..., 1])
    key = torch.where(valid, ang, torch.full_like(ang, 1e9))
    # Invalid candidates sort last; a stable sort keeps ties in order.
    order = torch.sort(key, dim=-1, stable=True).indices
    rx = torch.gather(rel[..., 0], -1, order)
    ry = torch.gather(rel[..., 1], -1, order)

    # Ring neighbour: the next slot, with the last valid one wrapping to 0.
    nx_ = torch.roll(rx, -1, dims=-1)
    ny_ = torch.roll(ry, -1, dims=-1)
    idx = torch.arange(24, device=ca.device)
    is_last = idx == (k[..., None] - 1)
    nx_ = torch.where(is_last, rx[..., :1], nx_)
    ny_ = torch.where(is_last, ry[..., :1], ny_)

    cross = rx * ny_ - ry * nx_
    cross = torch.where(idx < k[..., None], cross, torch.zeros_like(cross))
    area = 0.5 * cross.sum(dim=-1).abs()
    return torch.where(k >= 3, area, torch.zeros_like(area))


def rotated_iou_bev(boxes_a: torch.Tensor,
                    boxes_b: torch.Tensor) -> torch.Tensor:
    """Elementwise rotated BEV IoU of broadcast-compatible (..., 7)
    boxes -> (...,)."""
    boxes_a, boxes_b = torch.broadcast_tensors(boxes_a, boxes_b)
    # Recentre each pair at the midpoint of its two centres, so corner
    # coordinates are O(box size) and identical boxes far from the
    # sensor still give IoU 1.
    mid = 0.5 * (boxes_a[..., :2] + boxes_b[..., :2])
    shift = torch.cat([mid, torch.zeros_like(boxes_a[..., 2:])], dim=-1)
    ca = boxes_to_corners_bev(boxes_a - shift)
    cb = boxes_to_corners_bev(boxes_b - shift)
    inter = _quad_intersection_area(ca, cb)
    area_a = boxes_a[..., 3] * boxes_a[..., 4]
    area_b = boxes_b[..., 3] * boxes_b[..., 4]
    inter = torch.minimum(inter, torch.minimum(area_a, area_b))
    union = area_a + area_b - inter
    return inter / union.clamp_min(_EPS)


def rotated_iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor, *,
                       row_chunk: int = 0) -> torch.Tensor:
    """Pairwise rotated BEV IoU: (M, 7) x (N, 7) -> (M, N).

    ``row_chunk`` > 0 evaluates the matrix in row blocks to bound peak
    memory on large M * N."""
    if row_chunk and boxes_a.shape[0] > row_chunk:
        return torch.cat([
            rotated_iou_bev(block[:, None, :], boxes_b[None, :, :])
            for block in boxes_a.split(row_chunk)])
    return rotated_iou_bev(boxes_a[:, None, :], boxes_b[None, :, :])
