"""Host-side detection matching (copy of ``lisec_tpu/eval/detection.py``,
numpy).

Shared by the light recall eval (``DetectionPipeline.evaluate``) and the
KITTI AP evaluator (``eval/kitti_ap.py``). Its rotated BEV IoU is an
independent implementation (polygon clipping), also usable as an oracle
of the device op.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _corners(box: np.ndarray) -> np.ndarray:
    x, y, l, w, yaw = box[0], box[1], box[3], box[4], box[6]
    local = np.array([[l / 2, w / 2], [-l / 2, w / 2],
                      [-l / 2, -w / 2], [l / 2, -w / 2]])
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s], [s, c]])
    return local @ rot.T + np.array([x, y])


def _clip(poly, p1, p2):
    def cross2(u, v):
        return u[0] * v[1] - u[1] * v[0]

    out = []
    for i in range(len(poly)):
        a, b = poly[i], poly[(i + 1) % len(poly)]
        sa = cross2(p2 - p1, a - p1)
        sb = cross2(p2 - p1, b - p1)
        if sa >= -1e-8:
            out.append(a)
        if (sa >= -1e-8) != (sb >= -1e-8):
            out.append(a + sa / (sa - sb) * (b - a))
    return out


def _area(poly) -> float:
    if len(poly) < 3:
        return 0.0
    s = 0.0
    for i in range(len(poly)):
        a, b = poly[i], poly[(i + 1) % len(poly)]
        s += a[0] * b[1] - a[1] * b[0]
    return abs(s) / 2.0


def rotated_iou_bev_np(box_a: np.ndarray, box_b: np.ndarray) -> float:
    poly = list(_corners(box_a))
    cb = _corners(box_b)
    for k in range(4):
        poly = _clip(poly, cb[k], cb[(k + 1) % 4])
        if not poly:
            return 0.0
    inter = _area(poly)
    union = box_a[3] * box_a[4] + box_b[3] * box_b[4] - inter
    return float(inter / max(union, 1e-8))


def iou_3d_np(box_a: np.ndarray, box_b: np.ndarray) -> float:
    """Rotated 3D IoU: BEV intersection x z-overlap."""
    poly = list(_corners(box_a))
    cb = _corners(box_b)
    for k in range(4):
        poly = _clip(poly, cb[k], cb[(k + 1) % 4])
        if not poly:
            return 0.0
    inter_bev = _area(poly)
    za0, za1 = box_a[2] - box_a[5] / 2, box_a[2] + box_a[5] / 2
    zb0, zb1 = box_b[2] - box_b[5] / 2, box_b[2] + box_b[5] / 2
    zi = max(0.0, min(za1, zb1) - max(za0, zb0))
    inter = inter_bev * zi
    vol_a = box_a[3] * box_a[4] * box_a[5]
    vol_b = box_b[3] * box_b[4] * box_b[5]
    return float(inter / max(vol_a + vol_b - inter, 1e-8))


def _corners_vec(boxes: np.ndarray) -> np.ndarray:
    """(N, 7) -> (N, 4, 2) CCW BEV corners, vectorized."""
    x, y = boxes[:, 0], boxes[:, 1]
    l, w, yaw = boxes[:, 3], boxes[:, 4], boxes[:, 6]
    local = np.array([[0.5, 0.5], [-0.5, 0.5],
                      [-0.5, -0.5], [0.5, -0.5]])       # (4, 2)
    lx = local[None, :, 0] * l[:, None]
    ly = local[None, :, 1] * w[:, None]
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    cx = lx * c - ly * s + x[:, None]
    cy = lx * s + ly * c + y[:, None]
    return np.stack([cx, cy], axis=-1)


def _quad_inter_area_mat(ca: np.ndarray, cb: np.ndarray) -> np.ndarray:
    """Pairwise intersection area of CCW quads: (D,4,2) x (G,4,2) ->
    (D,G). Same candidate-enumeration scheme as the device op
    (ops/rotated_iou.py), in plain vectorized numpy (host: argsort and
    gathers are fine here)."""
    eps = 1e-8
    A = ca[:, None]                                     # (D,1,4,2)
    B = cb[None, :]                                     # (1,G,4,2)
    D, G = ca.shape[0], cb.shape[0]

    def inside(pts, quad):
        v0 = quad[..., :, None, :]
        v1 = np.roll(quad, -1, axis=-2)[..., :, None, :]
        p = pts[..., None, :, :]
        cr = ((v1[..., 0] - v0[..., 0]) * (p[..., 1] - v0[..., 1])
              - (v1[..., 1] - v0[..., 1]) * (p[..., 0] - v0[..., 0]))
        return (cr >= -eps).all(axis=-2)                # (D,G,4)

    in_ab = inside(A, B)
    in_ba = inside(B, A)

    p1 = A[..., :, None, :]
    p2 = np.roll(A, -1, axis=-2)[..., :, None, :]
    q1 = B[..., None, :, :]
    q2 = np.roll(B, -1, axis=-2)[..., None, :, :]
    d1, d2 = p2 - p1, q2 - q1
    denom = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    dq = q1 - p1
    t_num = dq[..., 0] * d2[..., 1] - dq[..., 1] * d2[..., 0]
    u_num = dq[..., 0] * d1[..., 1] - dq[..., 1] * d1[..., 0]
    safe = np.where(np.abs(denom) < eps, 1.0, denom)
    t, u = t_num / safe, u_num / safe
    ok = ((np.abs(denom) >= eps) & (t >= -eps) & (t <= 1 + eps)
          & (u >= -eps) & (u <= 1 + eps))
    ipts = p1 + t[..., None] * d1                       # (D,G,4,4,2)

    cand = np.concatenate(
        [np.broadcast_to(A, (D, G, 4, 2)),
         np.broadcast_to(B, (D, G, 4, 2)),
         ipts.reshape(D, G, 16, 2)], axis=2)            # (D,G,24,2)
    valid = np.concatenate(
        [in_ab, in_ba, ok.reshape(D, G, 16)], axis=2)

    k = valid.sum(axis=2)
    vf = valid[..., None]
    centroid = (cand * vf).sum(axis=2) / np.maximum(k, 1)[..., None]
    rel = cand - centroid[:, :, None, :]
    ang = np.arctan2(rel[..., 1], rel[..., 0])
    key = np.where(valid, ang, 1e9)
    order = np.argsort(key, axis=2)
    ring = np.take_along_axis(rel, order[..., None], axis=2)
    nxt = np.roll(ring, -1, axis=2)
    idx = np.arange(24)
    is_last = idx[None, None, :] == (k[..., None] - 1)
    nxt = np.where(is_last[..., None], ring[:, :, :1], nxt)
    cross = ring[..., 0] * nxt[..., 1] - ring[..., 1] * nxt[..., 0]
    cross = np.where(idx[None, None, :] < k[..., None], cross, 0.0)
    area = 0.5 * np.abs(cross.sum(axis=2))
    return np.where(k >= 3, area, 0.0)


def iou_matrix_np(det: np.ndarray, gt: np.ndarray,
                  metric: str = "3d") -> np.ndarray:
    """Pairwise rotated IoU matrix (D, G), metric '3d' or 'bev'."""
    if len(det) == 0 or len(gt) == 0:
        return np.zeros((len(det), len(gt)))
    inter_bev = _quad_inter_area_mat(_corners_vec(det), _corners_vec(gt))
    area_d = (det[:, 3] * det[:, 4])[:, None]
    area_g = (gt[:, 3] * gt[:, 4])[None, :]
    if metric == "bev":
        inter = np.minimum(inter_bev, np.minimum(area_d, area_g))
        return inter / np.maximum(area_d + area_g - inter, 1e-8)
    zd0 = det[:, 2] - det[:, 5] / 2
    zd1 = det[:, 2] + det[:, 5] / 2
    zg0 = gt[:, 2] - gt[:, 5] / 2
    zg1 = gt[:, 2] + gt[:, 5] / 2
    zi = np.maximum(
        0.0, np.minimum(zd1[:, None], zg1[None, :])
        - np.maximum(zd0[:, None], zg0[None, :]))
    inter = inter_bev * zi
    vol_d = (det[:, 3] * det[:, 4] * det[:, 5])[:, None]
    vol_g = (gt[:, 3] * gt[:, 4] * gt[:, 5])[None, :]
    inter = np.minimum(inter, np.minimum(vol_d, vol_g))
    return inter / np.maximum(vol_d + vol_g - inter, 1e-8)


def match_frame(det_boxes, det_labels, gt_boxes, gt_classes,
                *, iou_threshold: float = 0.5) -> Dict[str, int]:
    """Greedy one-to-one matching of detections to gt (BEV IoU)."""
    hit = np.zeros(len(gt_boxes), bool)
    for db, dl in zip(det_boxes, det_labels):
        for gi, (gb, gc) in enumerate(zip(gt_boxes, gt_classes)):
            if hit[gi] or gc != dl:
                continue
            if rotated_iou_bev_np(db, gb) >= iou_threshold:
                hit[gi] = True
                break
    return {
        "num_gt": int(len(gt_boxes)),
        "num_hit": int(hit.sum()),
        "num_det": int(len(det_boxes)),
    }
