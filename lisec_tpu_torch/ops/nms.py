"""Rotated NMS (port of ``lisec_tpu/ops/nms.py``).

Block-greedy suppression: each round takes the top ``block`` surviving
candidates at once. It is exactly greedy NMS: every candidate outside
the block scores below every block member, so a member is emitted iff
no higher-scoring emitted member of the same class in the block
suppresses it, and the emitted members then kill their overlaps. The
JAX version runs one ``while_loop`` per cloud under ``vmap``; here the
clouds (and, with ``class_parallel``, the per-class streams) run in
lockstep as one batch, each with its own ``cont`` flag, and the loop
goes on while any stream continues. A stream that has stopped keeps its
state, as under ``vmap``.

Every top-k here breaks ties by the lower index, as ``lax.top_k`` does:
``torch.topk`` promises no order for ties.

On the card the rounds run in one hand-written kernel
(``ops/cuda/rotated_nms.py``), of which ``_run_streams`` is the plain
version that CPU tensors take.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from lisec_tpu_torch.ops.cuda import rotated_nms as nms_kernel
from lisec_tpu_torch.ops.rotated_iou import rotated_iou_bev
from lisec_tpu_torch.utils.profiling import span


class NMSResult(NamedTuple):
    boxes: torch.Tensor       # (B, nms_post, D), D >= 7 as given
    scores: torch.Tensor      # (B, nms_post)
    labels: torch.Tensor      # (B, nms_post) int32
    valid: torch.Tensor       # (B, nms_post) bool


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, descending, ties by lower
    index first (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (S, P, 7), idx (S, ...) -> x[s, idx[s, ...]] of shape (S, ..., 7)."""
    flat = idx.reshape(idx.shape[0], -1)
    out = torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1]))
    return out.reshape(*idx.shape, x.shape[-1])


def _pair_iou(a, b):
    # Flatten the pair dims before the IoU (one flat batch of pairs).
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    a = a.expand(*shape, 7).reshape(-1, 7)
    b = b.expand(*shape, 7).reshape(-1, 7)
    return rotated_iou_bev(a, b).reshape(shape)


def _run_streams(alive, top_scores, top_boxes, top_labels, half_diag, *,
                 iou_threshold, score_threshold, block, k_near, full,
                 select, nms_post):
    """Block-greedy NMS of S independent streams in lockstep.

    alive/top_scores/top_labels/half_diag (S, P), top_boxes (S, P, 7),
    candidates sorted by score descending; ``top_labels`` are the keys
    within which boxes suppress each other. Returns (out_idx (S, post)
    int64 candidate slots, out_valid (S, post) bool)."""
    s, pre = alive.shape
    dev = alive.device
    neg_inf = torch.tensor(float("-inf"), device=dev)
    ar_pre = torch.arange(pre, device=dev)
    ar_block = torch.arange(block, device=dev)
    j = torch.zeros(s, dtype=torch.long, device=dev)
    cont = torch.ones(s, dtype=torch.bool, device=dev)
    out_idx = torch.zeros((s, nms_post), dtype=torch.long, device=dev)
    out_valid = torch.zeros((s, nms_post), dtype=torch.bool, device=dev)
    pad_col = torch.zeros((s, 1), dtype=torch.long, device=dev)

    # The host waits for the card once a round to learn whether any
    # stream goes on.
    active = cont & (j < nms_post)
    with span("nms.wait"):
        go = bool(active.any())
    while go:
        with span("nms.round"):
            if select == "scan":
                # Candidates are score-sorted, so this round's
                # top-`block` alive set is the first `block` alive slots
                # in index order. Unfilled slots read slot 0 and are
                # masked to -inf.
                pos = torch.cumsum(alive.long(), dim=1)
                slot = torch.where(alive & (pos <= block), pos - 1, block)
                bi = torch.zeros((s, block + 1), dtype=torch.long,
                                 device=dev).scatter_(
                    1, slot, ar_pre.expand(s, -1))[:, :block]
                filled = ar_block[None, :] < pos[:, -1:]
                bs = torch.where(filled, torch.gather(top_scores, 1, bi),
                                 neg_inf)
            else:
                bs, bi = top_k(torch.where(alive, top_scores, neg_inf), block)
            bok = bs > score_threshold
            bboxes = _rows(top_boxes, bi)                      # (S, block, 7)
            blabels = torch.gather(top_labels, 1, bi)

            if full:
                m = _pair_iou(bboxes[:, :, None, :],
                              top_boxes[:, None, :, :])
                near_idx = ar_pre.expand(s, block, pre)
                near_ok = blabels[:, :, None] == top_labels[:, None, :]
            else:
                # Circle prefilter: IoU > 0 needs the centres closer than
                # the sum of half-diagonals; keep the k_near nearest
                # same-class.
                dx = bboxes[:, :, None, 0] - top_boxes[:, None, :, 0]
                dy = bboxes[:, :, None, 1] - top_boxes[:, None, :, 1]
                d2 = dx ** 2 + dy ** 2
                rad = (torch.gather(half_diag, 1, bi)[:, :, None]
                       + half_diag[:, None, :])
                near = ((d2 < rad * rad)
                        & (blabels[:, :, None] == top_labels[:, None, :]))
                _, near_idx = top_k(torch.where(near, -d2, neg_inf), k_near)
                near_ok = torch.gather(near, 2, near_idx)
                m = _pair_iou(bboxes[:, :, None, :],
                              _rows(top_boxes, near_idx))

            mb = _pair_iou(bboxes[:, :, None, :], bboxes[:, None, :, :])
            same = blabels[:, :, None] == blabels[:, None, :]
            sup_in = (mb > iou_threshold) & same               # j suppresses i

            emitted = torch.zeros((s, block), dtype=torch.bool, device=dev)
            for i in range(block):
                hit = (emitted & sup_in[:, :, i]).any(dim=1)
                emitted[:, i] = bok[:, i] & ~hit

            # Emitted members kill their overlaps and themselves.
            kill = near_ok & (m > iou_threshold) & emitted[:, :, None]
            tgt = torch.cat([torch.where(kill, near_idx, pre).reshape(s, -1),
                             torch.where(emitted, bi, pre)], dim=1)
            killed = torch.zeros((s, pre + 1), dtype=torch.bool,
                                 device=dev).scatter_(1, tgt, True)
            new_alive = alive & ~killed[:, :pre]

            # Append this round's emissions in score order.
            pos = j[:, None] + torch.cumsum(emitted.long(), dim=1) - 1
            write = emitted & (pos < nms_post)
            slot = torch.where(write, pos, nms_post)
            new_idx = torch.cat([out_idx, pad_col], 1).scatter_(
                1, slot, bi)[:, :nms_post]
            new_valid = torch.cat([out_valid, pad_col.bool()], 1).scatter_(
                1, slot, True)[:, :nms_post]

            act = active[:, None]
            alive = torch.where(act, new_alive, alive)
            out_idx = torch.where(act, new_idx, out_idx)
            out_valid = torch.where(act, new_valid, out_valid)
            j = torch.where(active, j + write.sum(dim=1), j)
            # A block member below the threshold means every remaining
            # candidate is too: stopping is exactly equivalent to going
            # on.
            cont = torch.where(active, bok[:, block - 1], cont)
            active = cont & (j < nms_post)
            with span("nms.wait"):
                go = bool(active.any())
    return out_idx, out_valid


def rotated_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    *,
    iou_threshold: float,
    score_threshold: float = 0.0,
    nms_pre: int = 1024,
    nms_post: int = 128,
    block: int = 16,
    k_near: int = 0,
    select: str = "topk",
    class_parallel: int = 0,
    groups: torch.Tensor = None,
    stream_post: int = 0,
) -> NMSResult:
    """Greedy class-aware rotated NMS of each cloud's detections.

    boxes (B, A, D) with (x, y, z, l, w, h, yaw) first and any further
    columns (a velocity) carried along, scores (B, A), labels (B, A)
    int. Boxes of different classes never suppress each other; with
    ``groups`` (B, A) int, boxes of different groups never do, and those
    of one group do whatever their labels (CenterPoint's per-task NMS).
    Emits up to ``nms_post`` boxes per cloud in descending score order.
    ``block`` does not change the result; ``k_near`` > 0 bounds the
    exact-IoU work per emitted box to its k_near nearest candidates of
    its class (group) (0 = full rows); ``select`` is "topk" (masked
    top-k) or "scan" (first alive slots); ``class_parallel`` > 1 (the
    class count, or the group count with ``groups``) runs one stream per
    class (group) and merges them by score, each stream emitting up to
    ``stream_post`` boxes where that is given (else ``nms_post``). Under
    a profiler, the span ``nms``, and in it, on the card, ``nms.kernel``
    around the one launch of the rounds' kernel; on the CPU one
    ``nms.round`` a round and ``nms.wait`` where the host checks whether
    another round runs.
    """
    if select not in ("topk", "scan"):
        raise ValueError(f"select must be 'topk' or 'scan', got {select!r}")
    with span("nms", scores.device):
        b, a = scores.shape
        nms_pre = min(nms_pre, a)
        block = min(block, nms_pre)
        full = k_near <= 0 or k_near >= nms_pre
        k_near = nms_pre if full else k_near

        top_scores, order = top_k(scores, nms_pre)
        top_boxes = _rows(boxes, order)
        top_labels = torch.gather(labels, 1, order)
        top_keys = (top_labels if groups is None
                    else torch.gather(groups, 1, order))
        # The IoU and the prefilter read the first seven columns.
        iou_boxes = top_boxes[..., :7].contiguous()
        alive = top_scores > score_threshold
        half_diag = 0.5 * torch.hypot(top_boxes[..., 3], top_boxes[..., 4])
        kw = dict(iou_threshold=iou_threshold, score_threshold=score_threshold,
                  block=block, k_near=k_near, full=full, select=select,
                  nms_post=nms_post)

        if class_parallel > 1:
            cls_ids = torch.arange(class_parallel, device=scores.device)
            alive_c = alive[:, None, :] & (top_keys[:, None, :]
                                           == cls_ids[None, :, None])

            def rep(x):
                return x.repeat_interleave(class_parallel, dim=0)
            kw["nms_post"] = stream_post or nms_post
            oi, ov = nms_kernel.run_streams(
                alive_c.reshape(b * class_parallel, -1), rep(top_scores),
                rep(iou_boxes), rep(top_keys), rep(half_diag), **kw)
            oi = oi.reshape(b, -1)
            ov = ov.reshape(b, -1)
            # Each stream already descends, so the top nms_post by score is
            # the global greedy output in the global emission order.
            sc = torch.where(ov, torch.gather(top_scores, 1, oi),
                             float("-inf"))
            _, mi = top_k(sc, nms_post)
            out_idx = torch.gather(oi, 1, mi)
            out_valid = torch.gather(ov, 1, mi)
        else:
            out_idx, out_valid = nms_kernel.run_streams(
                alive, top_scores.contiguous(), iou_boxes, top_keys,
                half_diag, **kw)

        vb = torch.where(out_valid[..., None], _rows(top_boxes, out_idx), 0.0)
        vs = torch.where(out_valid, torch.gather(top_scores, 1, out_idx), 0.0)
        vl = torch.where(out_valid, torch.gather(top_labels, 1, out_idx), -1)
        return NMSResult(vb, vs, vl.to(torch.int32), out_valid)
