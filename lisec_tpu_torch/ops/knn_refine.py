"""Range-window kNN label refinement (port of
``lisec_tpu/ops/knn_refine.py``).

Each point takes the labels of the S x S pixel window around its pixel,
keeps the k whose range is nearest its own (within ``cutoff``) and votes
with weights 1 / (distance + 1e-3); a point with no vote keeps its
pixel's label. The steps:

1. the window table (B, H W, C): for each pixel the S^2 neighbour ranges
   and the S^2 neighbour labels packed as ``valid ? label + 1 : 0``
   (edges padded with zeros), C = 2 S^2 rounded up to a multiple of 4 so
   that the spread kernel moves it in 16-byte pieces (the extra channels
   are zero);
2. one stable sort of the points by pixel;
3. each pixel's table row delivered to the first point of its run by
   ``spread_accumulate`` with K = 1: a row's target is that point, or -1
   where the pixel holds no point, and the caller, which holds the
   inverse map (each run's first point names its pixel), hands it over
   so that the kernel skips its invert;
4. the row filled down the run by a doubling max-scan (every channel is
   >= 0) that reaches ``fill_depth`` points: deeper points get a zero row
   and fall back to their pixel's label;
5. the vote: ``top_k`` of the negated distances (ties to the lower
   index), the neighbours' labels by a gather, the weights summed per
   class over k in order, the first class of the largest sum;
6. the inverse permutation back to the original order.

The JAX package builds the table channel-leading, finds each pixel's
first point by a tag-merge sort and hands the spread ascending targets
(``cummax``) with zeroed values; those serve its kernel's layout and
in-order grid and are not carried over. The result is the same labels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lisec_tpu_torch.ops.cuda.spread_accumulate import spread_accumulate
from lisec_tpu_torch.ops.nms import top_k

_NO_VOTE = 3.0e38


def _build_table(image_range: torch.Tensor, image_labels: torch.Tensor,
                 image_mask: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H W, C) window table: S^2 ranges, S^2 packed labels, zeros to
    C = 2 S^2 rounded up to a multiple of 4; neighbour (dv, du) at
    channel ``(dv + S // 2) * S + du + S // 2``."""
    b, h, w = image_range.shape
    half, s2 = window // 2, window * window
    table = image_range.new_empty(b, h, w, -(-2 * s2 // 4) * 4)
    packed = torch.where(image_mask, image_labels.float() + 1.0, 0.0)
    for part, img in enumerate((image_range, packed)):
        padded = F.pad(img, (half, half, half, half))
        table[..., part * s2:(part + 1) * s2] = padded.unfold(
            1, window, 1).unfold(2, window, 1).reshape(b, h, w, s2)
    table[..., 2 * s2:] = 0.0
    return table.view(b, h * w, -1)


def _sort_points(pixel_pix: torch.Tensor, point_range: torch.Tensor):
    """Points sorted by pixel (stable): (pix_s, order, range_s)."""
    pix_s, order = torch.sort(pixel_pix, dim=1, stable=True)
    return pix_s, order, point_range.gather(1, order)


def _run_starts(pix_s: torch.Tensor) -> torch.Tensor:
    """(B, N) bool: the first point of each pixel's run."""
    prev = torch.cat([pix_s.new_full((pix_s.shape[0], 1), -1),
                      pix_s[:, :-1]], dim=1)
    return pix_s != prev


def _deliver_rows(table: torch.Tensor, pix_s: torch.Tensor):
    """Each pixel's table row at the first point of its run, zero rows
    elsewhere: (B, N, C). Returns (rows, targets (B, H W) int32: the first
    point of each pixel's run, -1 where it has none)."""
    b, hw, c = table.shape
    n = pix_s.shape[1]
    start = _run_starts(pix_s)
    pos = torch.arange(n, dtype=torch.int32, device=pix_s.device)
    # Non-starts write to a trash column hw.
    tgt = torch.full((b, hw + 1), -1, dtype=torch.int32,
                     device=pix_s.device).scatter_(
        1, torch.where(start, pix_s, hw).long(), pos.expand(b, n))[:, :hw]
    sources = torch.where(start, pix_s, -1).to(torch.int32)
    rows = spread_accumulate(table.view(b, 1, hw, c),
                             tgt.contiguous().view(b, 1, hw), num_out=n,
                             sources=sources.view(b, 1, n))
    return rows, tgt


def _forward_fill(first_rows: torch.Tensor, pix_s: torch.Tensor,
                  fill_depth: int) -> torch.Tensor:
    """Bounded segmented forward fill (channels are all >= 0)."""
    b, n = pix_s.shape
    posn = torch.arange(n, device=pix_s.device).expand(b, n)
    seg_start = torch.where(_run_starts(pix_s), posn, -1).cummax(1).values
    dist = posn - seg_start
    filled = first_rows
    sh = 1
    while sh < fill_depth:
        rolled = F.pad(filled[:, :-sh], (0, 0, sh, 0))
        filled = torch.where((dist >= sh)[..., None],
                             torch.maximum(filled, rolled), filled)
        sh *= 2
    return filled


def _vote(filled: torch.Tensor, range_s: torch.Tensor, s2: int, k: int,
          num_classes: int, cutoff: float):
    """k-NN select and class vote: (refined (B, N) int64, has_vote)."""
    nr = filled[..., :s2]
    nle = filled[..., s2:2 * s2]                        # 0 or label + 1
    nl = (nle - 1.0).clamp_min(0.0)
    dr = (nr - range_s[..., None]).abs()
    dr = torch.where((nle > 0.5) & (dr < cutoff), dr, _NO_VOTE)
    neg_d, sel = top_k(-dr, k)                          # (B, N, k)
    d = -neg_d
    wgt = torch.where(d < _NO_VOTE, 1.0 / (d + 1e-3), 0.0)
    lbl = nl.gather(-1, sel).long()
    classes = torch.arange(num_classes, device=lbl.device)
    votes = torch.zeros((*lbl.shape[:2], num_classes), device=lbl.device)
    for j in range(k):                                  # in order of k
        votes = votes + torch.where(lbl[..., j, None] == classes,
                                    wgt[..., j, None], 0.0)
    return votes.argmax(-1), wgt.sum(-1) > 0


def knn_refine_batch(point_range: torch.Tensor, pixel_pix: torch.Tensor,
                     image_range: torch.Tensor, image_labels: torch.Tensor,
                     image_mask: torch.Tensor, *, window: int = 5,
                     k: int = 5, num_classes: int = 20, cutoff: float = 1.0,
                     fill_depth: int = 32) -> torch.Tensor:
    """Refined per-point labels (B, N) int32 from the pixel labels.

    ``pixel_pix`` is the flat pixel id ``v * W + u`` of each point
    (``RangeImage.pixel_pix``); ``image_range``, ``image_labels`` and
    ``image_mask`` are (B, H, W)."""
    b, n = point_range.shape
    h, w = image_range.shape[1:]
    hw, s2 = h * w, window * window
    table = _build_table(image_range, image_labels, image_mask, window)
    pix_s, order, range_s = _sort_points(pixel_pix, point_range)
    first_rows, _ = _deliver_rows(table, pix_s)
    filled = _forward_fill(first_rows, pix_s, fill_depth)
    refined, has_vote = _vote(filled, range_s, s2, k, num_classes, cutoff)
    # Points with no vote (an empty or cut-off window, or deeper than
    # fill_depth in their pixel) keep their pixel's label.
    fallback = image_labels.reshape(b, hw).gather(
        1, pix_s.clamp(0, hw - 1).long())
    refined_s = torch.where(has_vote, refined, fallback.long())
    return torch.empty_like(refined_s).scatter_(
        1, order, refined_s).to(torch.int32)


def knn_refine(point_range: torch.Tensor, pixel_uv: torch.Tensor,
               image_range: torch.Tensor, image_labels: torch.Tensor,
               image_mask: torch.Tensor, *, window: int = 5, k: int = 5,
               num_classes: int = 20, cutoff: float = 1.0) -> torch.Tensor:
    """Single-cloud :func:`knn_refine_batch` taking (N, 2) (v, u)."""
    w = image_range.shape[-1]
    pix = pixel_uv[:, 0].int() * w + pixel_uv[:, 1].int()
    return knn_refine_batch(
        point_range[None], pix[None], image_range[None], image_labels[None],
        image_mask[None], window=window, k=k, num_classes=num_classes,
        cutoff=cutoff)[0]
