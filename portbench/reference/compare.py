"""The comparison that decides whether served detections are correct.

The numbers, over the clouds checked (a configuration's ``limits`` name
those it is held to):

``det_gap_mean``: every detection the program served has to be one that
the reference makes at some anchor of its class. For a served detection,
the gap to an anchor is the largest of its box differences (metres for
the centre, the log of the ratio for each size, radians for the heading)
and of its score difference. The heading's half is a choice between the
direction bin's two logits; where the reference's two lie within
``DIR_TIE`` of each other, or its heading within
``detect.HALF_TURN_EDGE`` of the boundary at which the half is taken,
rounding may serve either half, and the heading is compared modulo a
half turn. ``det_gap_mean`` is the mean, over served detections, of the
smallest gap over anchors. A box or score altered where it is produced
reads high. The mean and not the largest gap: bfloat16's worst detection
out of a thousand (a weak one, whose score and centre rest on cancelling
sums) reads as far off as fp8's, while over all detections fp8 lies ten
times further off.

``missed``: every detection that the reference's own greedy NMS keeps
with a score at least ``MARGIN`` above the score threshold (and above
the program's lowest served score plus ``MARGIN`` where the program's
list is full) has to be covered by a served detection of its class that
overlaps it by more than the NMS threshold less ``IOU_SLACK``, which is
what would have suppressed it (the slack: an overlap on the threshold
moves across it with rounding, and greedy NMS then keeps another set of
boxes). Its shortfall is the score by which the best such served
detection falls short, or the reference score itself where none
overlaps. ``missed`` is the largest shortfall, ``missed_mean`` their
mean over every such reference detection: steadier where rounding moves
a few scores far (SECOND's seed-drawn network), and as high where a
cloud is left out.

``extra_share``: every detection the program served has to be one that
the reference's own greedy NMS keeps. Served detections are taken in
descending score; each takes the reference detection of its class, not
yet taken, that overlaps it most, if by more than the NMS threshold less
``IOU_SLACK``. One that takes none is explained still where it overlaps
a reference detection of its class by an IoU within ``IOU_SLACK`` of the
NMS threshold (rounding moved a suppression across it), or where its
score lies less than ``MARGIN`` above the score threshold (or above the
reference's lowest kept score, where the reference's list is full). A
served score under the threshold is never explained, nor is a served
detection that a higher-scored one of its class overlaps by more than
the NMS threshold, where the configuration's ``nms_near`` does not bound
that one's reach (a duplicate that NMS kept, whatever its score; the
program's NMS compared those very boxes, so the slack there is
``OWN_IOU_SLACK``). The reference's NMS bounds each kept box's reach as
the configuration does. ``extra_share`` is the share of served
detections left unexplained: high where NMS suppresses too little or the
threshold is not applied, which neither number above sees (a duplicate
of a kept box lies at an anchor of the reference and covers what it
duplicates).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import detect

MARGIN = 0.05
IOU_SLACK = 0.1
# Direction logits this close are a tie: bfloat16 served the other half
# only where the reference's margin was below 0.016 on the card.
DIR_TIE = 0.1
# The program's float32 rotated IoU of two served boxes against the
# reference's float64 one.
OWN_IOU_SLACK = 0.01
# Candidates by which the program's set near a box may differ from the
# reference's (their ranks near ``nms_pre`` swap with rounding).
NEAR_SLACK = 8
_ROWS = 16


def _gaps(box: torch.Tensor, score: torch.Tensor, ref: Dict,
          index: bool = False):
    """For served boxes (P, 7) and scores (P,): the smallest gap to a
    reference anchor (every anchor of the served label is a candidate;
    labels are compared by the caller), and with ``index`` that anchor."""
    out, at = [], []
    rb, rs = ref["boxes"], ref["scores"]
    either = ref["edge"] | (ref["dir_margin"] < DIR_TIE)
    for i in range(0, box.shape[0], _ROWS):
        b = box[i:i + _ROWS, None, :]
        d = torch.maximum(
            (b[..., :3] - rb[None, :, :3]).abs().amax(-1),
            (b[..., 3:6].log() - rb[None, :, 3:6].log()).abs().amax(-1))
        dy = torch.remainder(b[..., 6] - rb[None, :, 6] + math.pi,
                             2 * math.pi) - math.pi
        dy = torch.where(either[None, :],
                         torch.minimum(dy.abs(), math.pi - dy.abs()),
                         dy.abs())
        ds = (score[i:i + _ROWS, None] - rs[None, :]).abs()
        g = torch.maximum(torch.maximum(d, dy), ds).min(1)
        out.append(g.values)
        at.append(g.indices)
    if not out:
        out, at = [box.new_zeros((0,))], [box.new_zeros((0,), dtype=int)]
    return (torch.cat(out), torch.cat(at)) if index else torch.cat(out)


def components(box: torch.Tensor, score: torch.Tensor, ref: Dict,
               a: torch.Tensor) -> Dict[str, float]:
    """The largest of each part of the gap between served detections and
    their nearest anchors ``a``: centre (m), size (log ratio), heading
    (rad, modulo a half turn), score."""
    rb = ref["boxes"][a]
    dy = torch.remainder(box[:, 6] - rb[:, 6] + math.pi, 2 * math.pi) \
        - math.pi
    parts = {"centre": (box[:, :3] - rb[:, :3]).abs().amax(-1),
             "size": (box[:, 3:6].log() - rb[:, 3:6].log()).abs().amax(-1),
             "heading": torch.minimum(dy.abs(), math.pi - dy.abs()),
             "score": (score - ref["scores"][a]).abs()}
    return {k: float(v.max()) if v.numel() else 0.0
            for k, v in parts.items()}


def explain(served: Dict[str, np.ndarray], ref: Dict) -> Dict:
    """The served detection of one cloud with the largest gap, the
    reference anchor that comes nearest to it, and the anchor whose box
    centre is nearest: for finding why a gap is large."""
    valid = np.asarray(served["valid"], bool)
    allr = ref["all"]
    dev = allr["boxes"].device
    box = torch.as_tensor(np.asarray(served["boxes"])[valid], device=dev)
    score = torch.as_tensor(np.asarray(served["scores"])[valid],
                            device=dev)
    if not box.numel():
        return {}
    g, a = _gaps(box, score, allr, index=True)
    i = int(g.argmax())
    near = int((allr["boxes"][:, :2] - box[i, :2]).norm(dim=1).argmin())

    def row(k):
        return {"box": allr["boxes"][k].tolist(),
                "score": float(allr["scores"][k]),
                "edge": bool(allr["edge"][k]),
                "dir_margin": float(allr["dir_margin"][k]), "anchor": k}
    return {"gap": float(g[i]), "served_box": box[i].tolist(),
            "served_score": float(score[i]), "best": row(int(a[i])),
            "nearest_centre": row(near)}


def compare_cloud(served: Dict[str, np.ndarray], ref: Dict,
                  cfg: Dict) -> Dict[str, float]:
    p = cfg["model"]["params"]
    thr = float(p.get("score_threshold", 0.1))
    nms_iou = float(p.get("nms_iou", 0.5))
    dev = ref["all"]["boxes"].device
    valid = np.asarray(served["valid"], bool)
    box = torch.as_tensor(np.asarray(served["boxes"])[valid],
                          dtype=torch.float32, device=dev)
    score = torch.as_tensor(np.asarray(served["scores"])[valid],
                            dtype=torch.float32, device=dev)
    label = torch.as_tensor(np.asarray(served["labels"])[valid],
                            dtype=torch.long, device=dev)

    gap = 0.0
    gaps: List[torch.Tensor] = []
    parts: Dict[str, float] = {}
    allr = ref["all"]
    for c in torch.unique(label).tolist():
        sel = label == c
        on = {k: v[allr["labels"] == c] for k, v in allr.items()}
        g, a = _gaps(box[sel], score[sel], on, index=True)
        if not g.numel():
            continue
        gaps.append(g)
        gap = max(gap, float(g.max()))
        for k, v in components(box[sel], score[sel], on, a).items():
            parts[k] = max(parts.get(k, 0.0), v)

    dets = ref["dets"]
    floor = thr + MARGIN
    if valid.all() and valid.size:
        floor = max(floor, float(score.min()) + MARGIN)
    missed = 0.0
    want = dets["scores"] >= floor
    if want.any():
        rb, rs, rl = (dets[k][want] for k in ("boxes", "scores", "labels"))
        iou = detect.pair_iou(rb, box)
        cover = (iou > nms_iou - IOU_SLACK) & (rl[:, None] == label[None, :])
        best = torch.where(cover, score[None, :].double(),
                           -math.inf).amax(1) if box.numel() else \
            torch.full_like(rs.double(), -math.inf)
        short = torch.where(torch.isfinite(best), (rs - best).clamp_min(0),
                            rs.double())
        missed = float(short.max())
        shorts = short.cpu()
    else:
        shorts = torch.zeros(0, dtype=torch.float64)
    return {"det_gap": gap, "missed": missed, "shorts": shorts,
            "extra": int(unexplained(box, score, label, ref, cfg).sum()),
            "parts": parts,
            "gaps": torch.cat(gaps).cpu() if gaps else torch.zeros(0)}


def _reach(box: torch.Tensor, label: torch.Tensor, allr: Dict,
           cfg: Dict) -> np.ndarray:
    """(P, P) bool: [i, j] where served box i's suppression reaches served
    box j. The configuration's ``nms_near`` bounds a kept box's reach to
    the ``nms_near`` candidates of its class, of the ``nms_pre`` best,
    nearest to it inside its overlap circle; the reference's candidates
    stand for the program's, with ``NEAR_SLACK`` of them to spare."""
    p = box.shape[0]
    near = int(cfg["budget"].get("nms_near", 0))
    if near <= 0 or not p:
        return np.ones((p, p), bool)
    top = torch.argsort(allr["scores"], descending=True,
                        stable=True)[:int(cfg["budget"]["nms_pre"])]
    cb, cl = allr["boxes"][top].double(), allr["labels"][top]
    box = box.double()
    d = torch.cdist(box[:, :2], cb[:, :2])
    rad = (0.5 * torch.hypot(box[:, 3], box[:, 4]))[:, None] \
        + 0.5 * torch.hypot(cb[:, 3], cb[:, 4])[None, :]
    inside = (d < rad) & (label[:, None] == cl[None, :])
    ranked = torch.sort(torch.where(inside, d, math.inf), dim=1).values
    closer = torch.searchsorted(ranked.contiguous(),
                                torch.cdist(box[:, :2], box[:, :2]))
    return (closer < near - NEAR_SLACK).cpu().numpy()


def unexplained(box: torch.Tensor, score: torch.Tensor,
                label: torch.Tensor, ref: Dict, cfg: Dict) -> np.ndarray:
    """(P,) bool: the served detections that the reference's NMS output
    ``ref["dets"]`` does not explain (see ``extra_share`` above)."""
    p = cfg["model"]["params"]
    thr = float(p.get("score_threshold", 0.1))
    nms_iou = float(p.get("nms_iou", 0.5))
    post = int(cfg["budget"]["nms_post"])
    dets = ref["dets"]
    iou = detect.pair_iou(box, dets["boxes"])
    iou = torch.where(label[:, None] == dets["labels"][None, :], iou,
                      0.0).cpu().numpy()
    s = score.cpu().numpy()
    ok = np.zeros(len(s), bool)
    # A served detection that a higher-scored one of its class overlaps
    # by more than the threshold: the program's NMS compared these very
    # boxes, so only its IoU's rounding (``OWN_IOU_SLACK``) separates
    # its reading from this one; it kept a duplicate.
    own = detect.pair_iou(box, box)
    own = torch.where(label[:, None] == label[None, :], own,
                      0.0).cpu().numpy()
    higher = s[None, :] > s[:, None]
    reach = _reach(box, label, ref["all"], cfg).T
    dup = ((own > nms_iou + OWN_IOU_SLACK) & higher & reach).any(1)
    if iou.shape[1]:
        free = iou.copy()
        for i in np.argsort(-s, kind="stable"):
            j = int(free[i].argmax())
            if free[i, j] > nms_iou - IOU_SLACK:
                ok[i] = True
                free[:, j] = -1.0
        ok |= ((iou > nms_iou - IOU_SLACK)
               & (iou <= nms_iou + IOU_SLACK)).any(1)
    floor = thr + MARGIN
    if dets["scores"].numel() >= post:
        floor = max(floor, float(dets["scores"].min()) + MARGIN)
    ok |= s < floor
    return ~ok | dup | (s < thr)


def compare(served: List[Dict[str, np.ndarray]], refs: List[Dict],
            cfg: Dict, detail: bool = False) -> Dict:
    """``det_gap_mean``, ``missed``, ``missed_mean`` and ``extra_share``
    over the clouds, with the counts;
    with ``detail``, for finding why a reading is high: the largest single
    gap, the largest of each of its parts, quantiles of the gaps, and
    ``explain`` of the cloud that holds the largest gap."""
    out = {"det_gap_mean": 0.0, "missed": 0.0, "missed_mean": 0.0,
           "extra_share": 0.0}
    worst_gap, gaps, shorts, parts = -1.0, [], [], {}
    n_served = n_ref = n_extra = 0
    for s, r in zip(served, refs):
        one = compare_cloud(s, r, cfg)
        gaps.append(one["gaps"])
        shorts.append(one["shorts"])
        out["missed"] = max(out["missed"], one["missed"])
        if detail and one["det_gap"] > worst_gap:
            worst_gap = one["det_gap"]
            out["detail"] = explain(s, r)
        for k, v in one["parts"].items():
            parts[k] = max(parts.get(k, 0.0), v)
        n_extra += one["extra"]
        n_served += int(np.asarray(s["valid"], bool).sum())
        n_ref += int(r["dets"]["scores"].numel())
    m = torch.cat(shorts) if shorts else torch.zeros(0)
    if m.numel():
        out["missed_mean"] = float(m.mean())
    g = torch.cat(gaps).double() if gaps else torch.zeros(0)
    if g.numel():
        out["det_gap_mean"] = float(g.mean())
        if detail:
            out["det_gap"] = float(g.max())
            out["parts"] = parts
            out["gap_stats"] = {f"q{int(q * 100)}": float(torch.quantile(g, q))
                                for q in (0.5, 0.9, 0.99)}
    out["extra_share"] = n_extra / max(n_served, 1)
    out.update(clouds=len(served), served_detections=n_served,
               extra_detections=n_extra,
               reference_detections=n_ref)
    return out
