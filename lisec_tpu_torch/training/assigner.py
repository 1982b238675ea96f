"""Anchor generation and target assignment (port of
``lisec_tpu/training/assigner.py``).

Anchors: one size per class (e.g. car (3.9, 1.6, 1.56)), two yaws
(0, pi/2), laid on the BEV output grid. Assignment: rotated BEV IoU
between anchors and gt boxes, per-class positive / negative thresholds,
and a forced match of every gt to its best anchor. An anchor's class
target is 0 for background, 1 + class for a positive, -1 for ignore.

Three functions give the same targets: ``assign_targets`` (the dense
reference: every anchor against every gt), ``assign_targets_windowed``
(each gt against the square window of anchors around it, reduced with
scatters) and ``assign_targets_windowed_batched`` (the train path: the
window pairs sorted by anchor and reduced by the segment paint kernel,
``lisec_tpu_torch/ops/cuda/segment_paint.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from lisec_tpu_torch.ops.boxes import encode_boxes
from lisec_tpu_torch.ops.cuda.segment_paint import EMPTY_MAX, segment_paint
from lisec_tpu_torch.ops.rotated_iou import (
    rotated_iou_bev, rotated_iou_matrix)


class AnchorConfig(NamedTuple):
    """Per-class anchor spec."""

    size: Tuple[float, float, float]      # (l, w, h)
    z_center: float
    pos_threshold: float
    neg_threshold: float


DEFAULT_ANCHORS = {
    "Car": AnchorConfig((3.9, 1.6, 1.56), -1.0, 0.6, 0.45),
    "Pedestrian": AnchorConfig((0.8, 0.6, 1.73), -0.6, 0.5, 0.35),
    "Cyclist": AnchorConfig((1.76, 0.6, 1.73), -0.6, 0.5, 0.35),
}

ROTATIONS = (0.0, np.pi / 2)


def generate_anchors(
    anchor_cfgs: Sequence[AnchorConfig],
    *,
    pc_range: Tuple[float, ...],
    feature_map_size: Tuple[int, int],     # (ny_out, nx_out)
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Dense anchor grid matching the head's (y, x, class, rot) layout.

    Returns (anchors (A, 7) f32, anchor_classes (A,) i32,
    pos_thr (A,), neg_thr (A,)) as host numpy.
    """
    ny, nx = feature_map_size
    xs = np.linspace(pc_range[0], pc_range[3], nx, endpoint=False) \
        + (pc_range[3] - pc_range[0]) / nx / 2
    ys = np.linspace(pc_range[1], pc_range[4], ny, endpoint=False) \
        + (pc_range[4] - pc_range[1]) / ny / 2

    anchors, classes, pos_t, neg_t = [], [], [], []
    for y in ys:
        for x in xs:
            for ci, cfg in enumerate(anchor_cfgs):
                for rot in ROTATIONS:
                    l, w, h = cfg.size
                    anchors.append([x, y, cfg.z_center, l, w, h, rot])
                    classes.append(ci)
                    pos_t.append(cfg.pos_threshold)
                    neg_t.append(cfg.neg_threshold)
    return (np.asarray(anchors, np.float32),
            np.asarray(classes, np.int32),
            np.asarray(pos_t, np.float32),
            np.asarray(neg_t, np.float32))


class AssignResult(NamedTuple):
    cls_targets: torch.Tensor   # (..., A) int32: 0 bg, 1 + class pos, -1 ign
    reg_targets: torch.Tensor   # (..., A, 7) encoded residuals
    dir_targets: torch.Tensor   # (..., A) int32 direction bin
    positive: torch.Tensor      # (..., A) bool


def _finish(best_iou, best_gt, forced, pos_thr, neg_thr, gt_boxes,
            gt_classes, anchors) -> AssignResult:
    """Thresholds, matched gt rows and encoded targets, for (..., A)
    ``best_iou`` / ``best_gt`` and (..., M, .) gts."""
    positive = (best_iou >= pos_thr) | forced
    negative = (best_iou < neg_thr) & ~positive
    idx = best_gt.long()
    matched_boxes = torch.gather(gt_boxes, -2,
                                 idx[..., None].expand(*idx.shape, 7))
    matched_cls = torch.gather(gt_classes, -1, idx)
    reg_targets = encode_boxes(matched_boxes, anchors)
    # Direction bin from the gt's absolute yaw (SECOND convention).
    dir_targets = (torch.remainder(matched_boxes[..., 6], 2 * np.pi)
                   < np.pi).to(torch.int32)
    cls_targets = torch.where(
        positive, matched_cls + 1,
        torch.where(negative, 0, -1)).to(torch.int32)
    return AssignResult(cls_targets, reg_targets, dir_targets, positive)


def _forced_matches(claim_idx: torch.Tensor, num_anchors: int):
    """Each claiming gt forces its anchor positive. claim_idx (..., M)
    holds the claimed anchor, ``num_anchors`` where the gt claims none.
    Returns (forced (..., A) bool, claimed_gt (..., A) int32); where two
    gts claim one anchor the higher gt index holds it (the last write of
    a sequential scatter)."""
    m = claim_idx.shape[-1]
    gt_ids = torch.arange(m, dtype=torch.int32, device=claim_idx.device
                          ).expand(claim_idx.shape)
    claimed = torch.full(claim_idx.shape[:-1] + (num_anchors + 1,), -1,
                         dtype=torch.int32, device=claim_idx.device)
    claimed = claimed.scatter_reduce(-1, claim_idx.long(), gt_ids, "amax",
                                     include_self=True)[..., :num_anchors]
    return claimed >= 0, claimed.clamp_min(0)


def assign_targets(anchors, anchor_classes, pos_thr, neg_thr, gt_boxes,
                   gt_classes, gt_mask, *, row_chunk: int = 0
                   ) -> AssignResult:
    """Single-frame dense assignment: anchors (A, 7) vs gt (M, 7)."""
    a = anchors.shape[0]
    gt_mask = gt_mask.to(torch.bool)
    iou = rotated_iou_matrix(anchors, gt_boxes, row_chunk=row_chunk)
    valid = gt_mask[None, :] & (anchor_classes[:, None]
                                == gt_classes[None, :])
    iou = torch.where(valid, iou, -1.0)                     # (A, M)

    best_iou, best_gt = _first_max(iou, dim=1)
    # Forced match: each valid gt claims its best anchor (ties -> lowest
    # anchor index). A padded gt's IoU column is all -1: it claims none.
    gt_best_iou, best_anchor_per_gt = _first_max(iou, dim=0)
    gt_claims = gt_mask & (gt_best_iou > 0)
    claim_idx = torch.where(gt_claims, best_anchor_per_gt, a)
    forced, claimed_gt = _forced_matches(claim_idx, a)
    best_gt = torch.where(forced, claimed_gt, best_gt.to(torch.int32))
    return _finish(best_iou, best_gt, forced, pos_thr, neg_thr, gt_boxes,
                   gt_classes, anchors)


def _first_max(x: torch.Tensor, dim: int):
    """(max, index of its first occurrence) along ``dim``: the tie-break
    of ``jnp.argmax``, taken as a min over the indices that hold the max
    so that it does not rest on the backend's ``argmax``."""
    mx = x.max(dim=dim, keepdim=True).values
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    ids = torch.arange(n, device=x.device).view(shape)
    first = torch.where(x == mx, ids, n).min(dim=dim).values
    return mx.squeeze(dim), first


def _window_anchors(class_sizes, class_z, gt_boxes, *, feature_map_size,
                    pc_range, window: int):
    """Window anchors around each gt, generated arithmetically from the
    grid. gt_boxes lead + (M, 7) -> (boxes lead + (M, K, 7) f32, aidx
    lead + (M, K) int32 flat anchor index, kc (K,) int32 class per slot),
    K = window^2 * C * R in (wy, wx, class, rot) order."""
    ny, nx = feature_map_size
    num_cls = class_sizes.shape[0]
    num_rot = len(ROTATIONS)
    w = window
    k = w * w * num_cls * num_rot
    dev = gt_boxes.device
    step_x = (pc_range[3] - pc_range[0]) / nx
    step_y = (pc_range[4] - pc_range[1]) / ny
    # The JAX package's jitted program multiplies by the f32 reciprocal
    # of the constant step (XLA rewrites the division); so does this.
    inv_x = float(np.float32(1.0) / np.float32(step_x))
    inv_y = float(np.float32(1.0) / np.float32(step_y))

    gx = (gt_boxes[..., 0] - pc_range[0]) * inv_x - 0.5
    gy = (gt_boxes[..., 1] - pc_range[1]) * inv_y - 0.5
    gx0 = (torch.round(gx).to(torch.int32) - w // 2).clamp(0, max(nx - w, 0))
    gy0 = (torch.round(gy).to(torch.int32) - w // 2).clamp(0, max(ny - w, 0))

    t = torch.arange(k, dtype=torch.int32, device=dev)
    ky = t // (w * num_cls * num_rot)
    kx = (t // (num_cls * num_rot)) % w
    kc = (t // num_rot) % num_cls
    kr = t % num_rot
    rot_k = torch.tensor(ROTATIONS, dtype=torch.float32, device=dev)[kr.long()]

    iy = gy0[..., None] + ky                          # lead + (M, K)
    ix = gx0[..., None] + kx
    ax = pc_range[0] + (ix.float() + 0.5) * step_x
    ay = pc_range[1] + (iy.float() + 0.5) * step_y
    size_k = class_sizes[kc.long()]                   # (K, 3)
    cols = [ax, ay] + [c.expand(ax.shape) for c in (
        class_z[kc.long()], size_k[:, 0], size_k[:, 1], size_k[:, 2], rot_k)]
    aidx = (iy * nx + ix) * (num_cls * num_rot) + kc * num_rot + kr
    return torch.stack(cols, dim=-1), aidx, kc


def _window_iou(class_sizes, class_z, gt_boxes, gt_classes, gt_mask, **kw):
    """Pair IoUs of every gt with its window anchors: (iou lead + (M, K),
    -1 where the pair is not allowed; pair_ok; aidx)."""
    win_boxes, aidx, kc = _window_anchors(class_sizes, class_z, gt_boxes,
                                          **kw)
    # + 0.0 turns -0.0 into +0.0, so that it cannot order differently
    # from the equality tests.
    iou = rotated_iou_bev(win_boxes, gt_boxes[..., None, :]) + 0.0
    pair_ok = gt_mask.to(torch.bool)[..., None] & (kc == gt_classes[..., None])
    return torch.where(pair_ok, iou, -1.0), pair_ok, aidx


def _window_claims(iou, aidx, gt_mask, num_anchors):
    """Forced match: per-gt first max within its window (the global best
    lies there by construction, and for one gt the window's flat order is
    the anchor-index order, so ties break as in the dense form)."""
    gt_best_iou, best_k = _first_max(iou, dim=-1)
    gt_best_anchor = torch.gather(aidx, -1, best_k[..., None])[..., 0]
    gt_claims = gt_mask.to(torch.bool) & (gt_best_iou > 0)
    claim_idx = torch.where(gt_claims, gt_best_anchor, num_anchors)
    return _forced_matches(claim_idx, num_anchors)


def assign_targets_windowed(anchors, anchor_classes, pos_thr, neg_thr,
                            class_sizes, class_z, gt_boxes, gt_classes,
                            gt_mask, *, feature_map_size, pc_range,
                            window: int = 32) -> AssignResult:
    """Single-frame windowed assignment: the outputs of
    :func:`assign_targets` from window^2 * C * R pairs per gt.

    IoU is 0 once the centre distance exceeds (gt diag + anchor diag) / 2,
    so a gt only meets the ``window``-cell square of anchors around it
    (``window * cell_size >= gt_diag + anchor_diag`` must hold). Anchors
    outside every window keep best_iou = -1 (dense: 0 or -1), below every
    negative threshold either way."""
    a = anchors.shape[0]
    m = gt_boxes.shape[0]
    iou, pair_ok, aidx = _window_iou(
        class_sizes, class_z, gt_boxes, gt_classes, gt_mask,
        feature_map_size=feature_map_size, pc_range=pc_range, window=window)
    iou_f = iou.reshape(-1)
    ok_f = pair_ok.reshape(-1)
    aidx_f = torch.where(ok_f, aidx.reshape(-1), a).long()
    gt_idx_f = torch.arange(m, device=iou.device).repeat_interleave(
        iou.shape[1])

    best_iou = torch.full((a + 1,), -1.0, device=iou.device).scatter_reduce(
        0, aidx_f, iou_f, "amax", include_self=True)
    # Winner pairs: float equality against the gathered max; ties go to
    # the lowest gt, as the dense argmax breaks them.
    winner = ok_f & (iou_f >= 0) & (iou_f == best_iou[aidx_f])
    best_gt = torch.full((a + 1,), m, device=iou.device).scatter_reduce(
        0, torch.where(winner, aidx_f, a), gt_idx_f, "amin",
        include_self=True)[:a]
    best_iou = best_iou[:a]
    best_gt = torch.where(best_iou >= 0, best_gt, 0).to(torch.int32)

    forced, claimed_gt = _window_claims(iou, aidx, gt_mask, a)
    best_gt = torch.where(forced, claimed_gt, best_gt)
    return _finish(best_iou, best_gt, forced, pos_thr, neg_thr, gt_boxes,
                   gt_classes, anchors)


def assign_targets_windowed_batched(anchors, anchor_classes, pos_thr,
                                    neg_thr, class_sizes, class_z, gt_boxes,
                                    gt_classes, gt_mask, *, feature_map_size,
                                    pc_range, window: int = 32
                                    ) -> AssignResult:
    """Batched windowed assignment (gt_boxes (B, M, 7)): the outputs of
    :func:`assign_targets_windowed` with the per-anchor reduction done by
    a sort and one segment paint.

    The window pairs are ordered by (anchor, -iou, gt), which makes each
    anchor's pairs a contiguous segment whose first row is the winner
    (max IoU, ties to the lowest gt). The paint then reduces the segments:
    channel 0 (max) = IoU -> best_iou; channel 1 (max) = M - gt on the
    segment's first row, -3e38 elsewhere -> the winner's gt; channel 2
    (sum) = 1 -> occupancy."""
    b, m = gt_boxes.shape[:2]
    a = anchors.shape[0]
    iou, pair_ok, aidx = _window_iou(
        class_sizes, class_z, gt_boxes, gt_classes, gt_mask,
        feature_map_size=feature_map_size, pc_range=pc_range, window=window)
    k = iou.shape[-1]
    iou_f = iou.reshape(b, m * k)
    aidx_f = torch.where(pair_ok, aidx, a).reshape(b, m * k)
    gt_idx_f = torch.arange(m, dtype=torch.int32, device=iou.device
                            )[None, :, None].expand(b, m, k).reshape(b, m * k)

    # The flat order is gt-ascending already, so a stable sort by -iou and
    # then a stable sort by anchor orders the pairs by (anchor, -iou, gt).
    _, by_iou = torch.sort(-iou_f, dim=1, stable=True)
    aidx_s, by_anchor = torch.sort(torch.gather(aidx_f, 1, by_iou), dim=1,
                                   stable=True)
    order = torch.gather(by_iou, 1, by_anchor)
    iou_s = torch.gather(iou_f, 1, order)
    gt_s = torch.gather(gt_idx_f, 1, order)
    is_start = torch.ones_like(aidx_s, dtype=torch.bool)
    is_start[:, 1:] = aidx_s[:, 1:] != aidx_s[:, :-1]

    vals = torch.stack([
        iou_s,
        torch.where(is_start, (m - gt_s).float(), EMPTY_MAX),
        torch.ones_like(iou_s)], dim=-1)                    # (B, MK, 3)
    tab = segment_paint(vals, aidx_s.contiguous(), num_cells=a, num_max=2)
    occupied = tab[..., 2] > 0.0                            # (B, A)
    best_iou = torch.where(occupied, tab[..., 0], -1.0)
    best_gt = torch.where(occupied & (best_iou >= 0),
                          m - torch.round(tab[..., 1].clamp_min(0.0)
                                          ).to(torch.int32), 0)
    best_gt = best_gt.clamp(0, m - 1)

    forced, claimed_gt = _window_claims(iou, aidx, gt_mask, a)
    best_gt = torch.where(forced, claimed_gt, best_gt)
    return _finish(best_iou, best_gt, forced, pos_thr, neg_thr, gt_boxes,
                   gt_classes, anchors)
