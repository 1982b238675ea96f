"""Anchors, box decoding, rotated BEV IoU and greedy NMS, written plainly
for the reference.

Boxes are ``(x, y, z, l, w, h, yaw)``. The anchor grid, the box coding
and the direction-bin rule follow PointPillars and SECOND as the
configuration states them (one anchor size per class, yaws 0 and pi/2,
centres on the output grid's cells, diagonal-normalised residuals, size
residuals clamped to [-10, 4]). The IoU clips one rectangle by the
other (Sutherland-Hodgman) in float64, and NMS is the textbook greedy
loop: candidates in score order, each kept unless a kept box of its class
overlaps it by more than the threshold, where the configuration bounds
each kept box's reach to its ``nms_near`` nearest candidates.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

# Per class: (l, w, h), z centre. The detector's car anchor and its
# pedestrian and cyclist ones, as the configuration's classes name them.
ANCHOR_SIZES = {
    "Car": ((3.9, 1.6, 1.56), -1.0),
    "Pedestrian": ((0.8, 0.6, 1.73), -0.6),
    "Cyclist": ((1.76, 0.6, 1.73), -0.6),
}
YAWS = (0.0, math.pi / 2)


def anchors(class_names: Sequence[str], pc_range: Sequence[float],
            fmap: Sequence[int], device) -> Dict[str, torch.Tensor]:
    """The anchor grid in (y, x, class, yaw) order: ``boxes`` (A, 7) f32
    and ``labels`` (A,) int64."""
    ny, nx = fmap
    dx = (pc_range[3] - pc_range[0]) / nx
    dy = (pc_range[4] - pc_range[1]) / ny
    xs = pc_range[0] + (np.arange(nx) + 0.5) * dx
    ys = pc_range[1] + (np.arange(ny) + 0.5) * dy
    rows, labels = [], []
    for y in ys:
        for x in xs:
            for ci, name in enumerate(class_names):
                (l, w, h), z = ANCHOR_SIZES[name]
                for yaw in YAWS:
                    rows.append((x, y, z, l, w, h, yaw))
                    labels.append(ci)
    return {"boxes": torch.tensor(np.asarray(rows, np.float32),
                                  device=device),
            "labels": torch.tensor(labels, device=device)}


# Headings within this of the half-turn boundary: rounding may put them
# on either side, which turns the decoded heading by pi.
HALF_TURN_EDGE = 0.05


def decode(deltas: torch.Tensor, anc: torch.Tensor,
           dir_logits: torch.Tensor):
    """Residuals (..., 7) against anchors (..., 7), with the direction
    bin's half of the heading -> (boxes (..., 7), edge (...,) bool: the
    heading lies within ``HALF_TURN_EDGE`` of the half-turn boundary,
    margin (...,): by how much the direction bin's choice won)."""
    xa, ya, za, la, wa, ha, ra = anc.unbind(-1)
    tx, ty, tz, tl, tw, th, tr = deltas.unbind(-1)
    diag = torch.sqrt(la * la + wa * wa)
    yaw = torch.remainder(tr + ra, math.pi)
    edge = (yaw < HALF_TURN_EDGE) | (yaw > math.pi - HALF_TURN_EDGE)
    yaw = torch.where(dir_logits[..., 1] > dir_logits[..., 0], yaw,
                      yaw - math.pi)
    return torch.stack([
        tx * diag + xa, ty * diag + ya, tz * ha + za,
        torch.exp(tl.clamp(-10.0, 4.0)) * la,
        torch.exp(tw.clamp(-10.0, 4.0)) * wa,
        torch.exp(th.clamp(-10.0, 4.0)) * ha, yaw], dim=-1), edge, \
        (dir_logits[..., 1] - dir_logits[..., 0]).abs()


def _corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> (..., 4, 2) BEV corners, counter-clockwise."""
    x, y, l, w, yaw = (boxes[..., i] for i in (0, 1, 3, 4, 6))
    sx = torch.stack([l, -l, -l, l], -1) / 2
    sy = torch.stack([w, w, -w, -w], -1) / 2
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    return torch.stack([x[..., None] + sx * c - sy * s,
                        y[..., None] + sx * s + sy * c], -1)


def _clip(poly: torch.Tensor, count: torch.Tensor, a: torch.Tensor,
          b: torch.Tensor):
    """Clip polygons (P, M, 2) with ``count`` vertices by the half-plane
    left of the directed edge a -> b (P, 2). Returns (poly, count)."""
    p, m, _ = poly.shape
    idx = torch.arange(m, device=poly.device)
    nxt = torch.where(idx[None, :] + 1 < count[:, None], idx[None, :] + 1,
                      0)
    q = torch.gather(poly, 1, nxt[..., None].expand(-1, -1, 2))
    e = (b - a)[:, None, :]

    def side(v):
        return e[..., 0] * (v[..., 1] - a[:, None, 1]) \
            - e[..., 1] * (v[..., 0] - a[:, None, 0])
    sp, sq = side(poly), side(q)
    live = idx[None, :] < count[:, None]
    keep_p = live & (sp >= 0)
    cross = live & ((sp >= 0) != (sq >= 0))
    t = sp / torch.where(cross, sp - sq, torch.ones_like(sp))
    x = poly + t[..., None] * (q - poly)
    cand = torch.stack([poly, x], 2).reshape(p, 2 * m, 2)
    flag = torch.stack([keep_p, cross], 2).reshape(p, 2 * m)
    # Stable compaction of the flagged vertices, in order.
    order = torch.sort((~flag).to(torch.int8), dim=1, stable=True).indices
    out = torch.gather(cand, 1, order[..., None].expand(-1, -1, 2))
    return out[:, :m], flag.sum(1).clamp_max(m)


def iou_bev(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotated BEV IoU of paired boxes a, b (P, 7) -> (P,), in float64."""
    a, b = a.double(), b.double()
    mid = (a[:, :2] + b[:, :2]) / 2
    shift = torch.cat([mid, torch.zeros_like(a[:, 2:])], 1)
    ca, cb = _corners(a - shift), _corners(b - shift)
    p = a.shape[0]
    poly = torch.zeros((p, 8, 2), dtype=torch.float64, device=a.device)
    poly[:, :4] = ca
    count = torch.full((p,), 4, device=a.device)
    for k in range(4):
        poly, count = _clip(poly, count, cb[:, k], cb[:, (k + 1) % 4])
    idx = torch.arange(8, device=a.device)
    nxt = torch.where(idx[None, :] + 1 < count[:, None], idx[None, :] + 1, 0)
    q = torch.gather(poly, 1, nxt[..., None].expand(-1, -1, 2))
    cr = poly[..., 0] * q[..., 1] - poly[..., 1] * q[..., 0]
    inter = 0.5 * torch.where(idx[None, :] < count[:, None], cr, 0.0).sum(1)
    inter = torch.where(count >= 3, inter.abs(), 0.0)
    ua = a[:, 3] * a[:, 4] + b[:, 3] * b[:, 4] - inter
    return inter / ua.clamp_min(1e-12)


def pair_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, 7) x (N, 7) -> (M, N) IoU, computed only where the BEV
    circles around the two boxes meet (0 elsewhere)."""
    m, n = a.shape[0], b.shape[0]
    out = torch.zeros((m, n), dtype=torch.float64, device=a.device)
    if m == 0 or n == 0:
        return out
    ra = 0.5 * torch.hypot(a[:, 3], a[:, 4])
    rb = 0.5 * torch.hypot(b[:, 3], b[:, 4])
    d = torch.cdist(a[:, :2].double(), b[:, :2].double())
    i, j = torch.nonzero(d < (ra[:, None] + rb[None, :]).double(),
                         as_tuple=True)
    if i.numel():
        out[i, j] = iou_bev(a[i], b[j])
    return out


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor,
               labels: torch.Tensor, *, iou_thr: float, score_thr: float,
               pre: int, post: int, near: int = 0
               ) -> Dict[str, torch.Tensor]:
    """One cloud's detections: of the ``pre`` best anchors, those above
    ``score_thr``, greedily suppressed per class at ``iou_thr``, at most
    ``post`` kept, in descending score. With ``near`` (the
    configuration's ``nms_near``) a kept box suppresses only the ``near``
    candidates of its class, among the ``pre``, whose centres lie
    nearest to its own inside the circle where an overlap can be (closer
    than the sum of the two half diagonals; ties to the better-ranked)."""
    order = torch.sort(scores, descending=True, stable=True).indices[:pre]
    b, s, lab = boxes[order], scores[order], labels[order]
    same = (lab[:, None] == lab[None, :]).cpu().numpy()
    over = (pair_iou(b, b).cpu().numpy() > iou_thr) & same
    if 0 < near < len(order):
        xy = b[:, :2].cpu().numpy().astype(np.float64)
        d2 = ((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1)
        half = 0.5 * np.hypot(*b[:, 3:5].cpu().numpy().astype(np.float64).T)
        circle = same & (d2 < (half[:, None] + half[None, :]) ** 2)
        rank = np.argsort(np.where(circle, d2, np.inf), axis=1,
                          kind="stable")[:, :near]
        reach = np.zeros_like(circle)
        np.put_along_axis(reach, rank, True, axis=1)
        over &= reach & circle
    dead = (s <= score_thr).cpu().numpy()
    keep: List[int] = []
    for i in range(len(order)):
        if dead[i]:
            continue
        keep.append(i)
        if len(keep) == post:
            break
        dead |= over[i]
    k = torch.tensor(keep, dtype=torch.long, device=boxes.device)
    return {"boxes": b[k], "scores": s[k], "labels": lab[k]}
