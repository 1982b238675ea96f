"""KITTI detection AP (copy of ``lisec_tpu/eval/kitti_ap.py``, numpy
on the host).

The KITTI protocol: per-class IoU thresholds (car 0.7, pedestrian and
cyclist 0.5), easy / moderate / hard difficulty buckets with ignored-gt
semantics, greedy score-ordered matching, 11-point and 40-point
interpolated AP (``evaluate_kitti_ap``), and the devkit's two-pass
official protocol (``evaluate_kitti_ap_official``). Metrics: 3D IoU (BEV
polygon x z-overlap) and BEV IoU.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from lisec_tpu_torch.eval.detection import iou_matrix_np

CLASS_IOU_THRESHOLDS = {0: 0.7, 1: 0.5, 2: 0.5}   # Car, Pedestrian, Cyclist
DIFFICULTY_NAMES = ("easy", "moderate", "hard")


def _match_frame(det_scores, iou, gt_ignored, iou_thr) -> List:
    """Greedy matching in score order for one frame, from a
    precomputed (D, G) IoU matrix (computed ONCE per frame/class/metric
    and reused across the 3 difficulty buckets).

    Each detection (in descending score order) takes the untaken gt with
    the highest IoU >= threshold (ties -> lowest gt index). Each gt
    matches at most once.
    """
    order = np.argsort(-det_scores, kind="stable")
    taken = np.zeros(iou.shape[1], bool)
    out = []
    for di in order:
        if iou.shape[1]:
            row = np.where(taken, -1.0, iou[di])
            gi = int(np.argmax(row))
            best = row[gi]
        else:
            best = -1.0
        if best < iou_thr:       # thr > 0, so this also covers iou == 0
            out.append((det_scores[di], "fp"))
        elif gt_ignored[gi]:
            taken[gi] = True
            out.append((det_scores[di], "ignore"))
        else:
            taken[gi] = True
            out.append((det_scores[di], "tp"))
    return out


def _average_precision(outcomes, num_gt, num_points) -> float:
    """AP from pooled detection outcomes via interpolated PR curve."""
    if num_gt == 0:
        return 0.0
    outcomes = sorted(
        [o for o in outcomes if o[1] != "ignore"],
        key=lambda x: -x[0])
    tp = np.cumsum([1 if k == "tp" else 0 for _, k in outcomes])
    fp = np.cumsum([1 if k == "fp" else 0 for _, k in outcomes])
    if len(tp) == 0:
        return 0.0
    recall = tp / num_gt
    precision = tp / np.maximum(tp + fp, 1)
    # Monotone envelope.
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    if num_points == 11:
        samples = np.linspace(0.0, 1.0, 11)
    else:
        samples = np.linspace(1.0 / 40, 1.0, 40)
    ap = 0.0
    for r in samples:
        idx = np.searchsorted(recall, r, side="left")
        ap += precision[idx] if idx < len(precision) else 0.0
    return float(ap / len(samples) * 100.0)


def evaluate_kitti_ap(
    detections: Sequence[Dict[str, np.ndarray]],
    ground_truths: Sequence[Dict[str, np.ndarray]],
    *,
    class_ids: Sequence[int] = (0,),
    metric: str = "3d",
    num_points: int = 40,
) -> Dict[str, float]:
    """KITTI AP over a dataset.

    detections: per frame {'boxes' (D,7), 'scores' (D,), 'labels' (D,)}.
    ground_truths: per frame {'boxes' (G,7), 'classes' (G,),
                   'difficulty' (G,) int (-1 = ignore always)}.
    Returns {'<cls>_<metric>_ap_<difficulty>': AP in percent}.
    """
    results = {}
    for cls in class_ids:
        iou_thr = CLASS_IOU_THRESHOLDS.get(cls, 0.5)
        # One (D, G) IoU matrix per frame, computed once and reused by
        # all three difficulty buckets (the bucket only changes which
        # gts are "ignored", not the geometry).
        frames = []
        for det, gt in zip(detections, ground_truths):
            sel = det["labels"] == cls
            g_cls = gt["classes"] == cls
            diff = gt.get(
                "difficulty", np.zeros(len(gt["boxes"]), np.int32))
            iou = iou_matrix_np(
                np.asarray(det["boxes"][sel], np.float64),
                np.asarray(gt["boxes"][g_cls], np.float64), metric)
            frames.append((det["scores"][sel], iou, diff[g_cls]))

        for bucket, bucket_name in enumerate(DIFFICULTY_NAMES):
            outcomes, num_gt = [], 0
            for scores, iou, diff in frames:
                # Current-bucket gts count; harder/unknown ones are
                # "ignored": matching them is neither TP nor FP.
                g_valid = (diff >= 0) & (diff <= bucket)
                num_gt += int(g_valid.sum())
                outcomes.extend(_match_frame(
                    scores, iou, ~g_valid, iou_thr))
            results[f"class{cls}_{metric}_ap_{bucket_name}"] = \
                _average_precision(outcomes, num_gt, num_points)
    return results


def _get_thresholds(scores, num_gt: int, num_pts: int) -> np.ndarray:
    """Official KITTI score-threshold sampling: walk the sorted
    TP-capable scores and keep one per ~1/(num_pts-1) recall step."""
    scores = np.sort(np.asarray(scores, np.float64))[::-1]
    thresholds, current = [], 0.0
    for i, s in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current) < (current - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(s)
        current += 1.0 / (num_pts - 1)
    return np.asarray(thresholds)


def evaluate_kitti_ap_official(
    detections: Sequence[Dict[str, np.ndarray]],
    ground_truths: Sequence[Dict[str, np.ndarray]],
    *,
    class_ids: Sequence[int] = (0,),
    metric: str = "3d",
    num_points: int = 40,
) -> Dict[str, float]:
    """KITTI AP under the official protocol.

    Matches the devkit's two-pass scheme: (1) per difficulty bucket,
    collect each non-ignored gt's best-matching detection SCORE (greedy
    by score among IoU > threshold) and derive the 41 (or 11) official
    recall-sampled score thresholds; (2) for every threshold, greedy
    per-frame matching by IoU among detections above it — ignored gts
    absorb detections without counting — then TP/FP -> precision, with
    the monotone max-smoothing, averaged over the threshold samples
    (R40 skips the recall-0 sample; R11 keeps it).

    Vectorized: one (D, G) IoU matrix per frame/class (reused by every
    bucket and threshold), and the threshold axis is batched — per gt
    one argmax over a (T, D) array.

    No image-plane information exists in this stack, so the devkit's
    2D-bbox-height difficulty criterion for DETECTIONS is not applied
    (gt difficulty from the dataset labels is).
    """
    n_pts = 41 if num_points == 40 else 11
    results: Dict[str, float] = {}
    for cls in class_ids:
        iou_thr = CLASS_IOU_THRESHOLDS.get(cls, 0.5)
        frames = []
        for det, gt in zip(detections, ground_truths):
            dsel = det["labels"] == cls
            gsel = gt["classes"] == cls
            iou = iou_matrix_np(
                np.asarray(det["boxes"][dsel], np.float64),
                np.asarray(gt["boxes"][gsel], np.float64), metric)
            diff = gt.get("difficulty",
                          np.zeros(len(gt["boxes"]), np.int32))[gsel]
            frames.append((np.asarray(det["scores"][dsel]), iou, diff))

        for bucket, bucket_name in enumerate(DIFFICULTY_NAMES):
            num_gt = 0
            tp_scores = []
            for scores, iou, diff in frames:
                g_valid = (diff >= 0) & (diff <= bucket)
                num_gt += int(g_valid.sum())
                if len(scores) == 0:
                    continue
                # Pass 1: per valid gt, highest-score unassigned det
                # with IoU > thr.
                assigned = np.zeros(len(scores), bool)
                for g in range(iou.shape[1]):
                    if not g_valid[g]:
                        continue
                    cand = (iou[:, g] > iou_thr) & ~assigned
                    if not cand.any():
                        continue
                    j = np.argmax(np.where(cand, scores, -np.inf))
                    assigned[j] = True
                    tp_scores.append(scores[j])
            key = f"class{cls}_{metric}_ap_{bucket_name}_official"
            if num_gt == 0 or not tp_scores:
                results[key] = 0.0
                continue
            thresholds = _get_thresholds(tp_scores, num_gt, n_pts)
            t = len(thresholds)

            tp = np.zeros(t)
            fp = np.zeros(t)
            for scores, iou, diff in frames:
                if len(scores) == 0:
                    continue
                g_valid = (diff >= 0) & (diff <= bucket)
                g_ignored = ~g_valid
                score_ok = scores[None, :] >= thresholds[:, None]
                assigned = np.zeros((t, len(scores)), bool)
                ign_assigned = np.zeros((t, len(scores)), bool)
                rows = np.arange(t)
                # Valid gts first (they claim detections for TP)...
                for g in range(iou.shape[1]):
                    if not g_valid[g]:
                        continue
                    cand = (score_ok & ~assigned
                            & (iou[:, g] > iou_thr)[None, :])
                    vals = np.where(cand, iou[:, g][None, :], -1.0)
                    j = np.argmax(vals, axis=1)
                    hit = vals[rows, j] > 0
                    tp += hit
                    assigned[rows[hit], j[hit]] = True
                # ...then ignored gts absorb leftovers (not FP).
                for g in range(iou.shape[1]):
                    if g_valid[g]:
                        continue
                    cand = (score_ok & ~assigned & ~ign_assigned
                            & (iou[:, g] > iou_thr)[None, :])
                    vals = np.where(cand, iou[:, g][None, :], -1.0)
                    j = np.argmax(vals, axis=1)
                    hit = vals[rows, j] > 0
                    ign_assigned[rows[hit], j[hit]] = True
                fp += (score_ok & ~assigned & ~ign_assigned).sum(axis=1)

            precision = tp / np.maximum(tp + fp, 1)
            # Monotone envelope over the recall samples.
            for i in range(t - 2, -1, -1):
                precision[i] = max(precision[i], precision[i + 1])
            full = np.zeros(n_pts)
            full[:t] = precision
            if n_pts == 41:
                ap = full[1:].sum() / 40.0
            else:
                ap = full.sum() / 11.0
            results[key] = float(ap * 100.0)
    return results


def collect_detections(pipeline, *, split: str = "val",
                       max_frames: int = 0) -> Tuple[List, List]:
    """Run ``pipeline.infer`` over a split (``Pipeline.eval_outputs``:
    in order, whole batches, each batch's outputs moved to the host once)
    and return per frame its kept detections and its gts as numpy.
    ``max_frames`` (0: all) stops after the batch that reaches it."""
    bs = pipeline.cfg.train.batch_size
    dets, gts = [], []
    for batch, out in pipeline.eval_outputs(split, -(-max_frames // bs)):
        for i in range(len(batch["points"])):
            v = out["valid"][i]
            dets.append({
                "boxes": out["boxes"][i][v],
                "scores": out["scores"][i][v],
                "labels": out["labels"][i][v],
            })
            gm = batch["gt_mask"][i]
            gts.append({
                "boxes": batch["gt_boxes"][i][gm],
                "classes": batch["gt_classes"][i][gm],
                "difficulty": batch.get(
                    "difficulty",
                    np.zeros_like(batch["gt_classes"]))[i][gm],
            })
    return dets, gts


def kitti_ap(dets, gts, num_classes: int, *, metric: str = "3d"
             ) -> Dict[str, float]:
    """The simple and the official KITTI AP of every class."""
    cls_ids = list(range(num_classes))
    out = evaluate_kitti_ap(dets, gts, class_ids=cls_ids, metric=metric)
    out.update(evaluate_kitti_ap_official(
        dets, gts, class_ids=cls_ids, metric=metric))
    return out


def evaluate_pipeline_ap(pipeline, *, split: str = "val",
                         metric: str = "3d",
                         max_frames: int = 0) -> Dict[str, float]:
    """Run inference over a split and compute KITTI AP. The weights are
    the pipeline's model, so no state is passed."""
    dets, gts = collect_detections(pipeline, split=split,
                                   max_frames=max_frames)
    return kitti_ap(dets, gts, len(pipeline.class_names), metric=metric)
