"""Losses (port of ``cross_entropy``, ``sigmoid_focal_loss``,
``smooth_l1``, ``sin_difference`` and ``lovasz_softmax`` from
``lisec_tpu/training/losses.py``): the segmentation cross-entropy and
the range segmenter's Lovász-softmax; the detectors' focal loss (alpha
0.25, gamma 2) and smooth-L1 with SECOND's sin-difference angle trick.
The other workloads' losses come with those workloads.

Under a data mesh (``lisec_tpu_torch.parallel``) each returns this
rank's share of the loss over the global batch: the ranks' shares sum
to it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from lisec_tpu_torch.parallel.mesh import all_gather, global_sum, share


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  mask: Optional[torch.Tensor] = None,
                  class_weights: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Mean softmax cross-entropy over the entries where ``mask`` (if
    given) is set and the label is not negative; ``class_weights``
    weights each entry by its label's weight. The denominator counts the
    global batch's entries."""
    safe = labels.clamp_min(0).long()
    ce = -torch.log_softmax(logits, dim=-1).gather(
        -1, safe[..., None])[..., 0]
    if class_weights is not None:
        ce = ce * class_weights[safe]
    valid = labels >= 0
    if mask is not None:
        valid = valid & mask.bool()
    denom = global_sum(valid.sum()).clamp_min(1)
    return torch.where(valid, ce, 0.0).sum() / denom


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, *,
                       alpha: float = 0.25, gamma: float = 2.0
                       ) -> torch.Tensor:
    """Per-element focal loss (RetinaNet form). targets in {0, 1}."""
    p = torch.sigmoid(logits)
    # The numerically stable log-sigmoid form of binary cross-entropy.
    ce = -targets * F.logsigmoid(logits) \
        - (1 - targets) * F.logsigmoid(-logits)
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return a_t * ((1 - p_t) ** gamma) * ce


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, *,
              beta: float = 1.0 / 9.0) -> torch.Tensor:
    """Huber / smooth-L1 per element."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def sin_difference(pred_boxes: torch.Tensor, target_boxes: torch.Tensor):
    """SECOND's angle trick: replace (rp, rt) by
    (sin(rp) cos(rt), cos(rp) sin(rt)) so the loss sees sin(rp - rt).
    Boxes are (..., 7) rows."""
    rp, rt = pred_boxes[..., 6:7], target_boxes[..., 6:7]
    pred = torch.cat([pred_boxes[..., :6], torch.sin(rp) * torch.cos(rt)],
                     dim=-1)
    target = torch.cat(
        [target_boxes[..., :6], torch.cos(rp) * torch.sin(rt)], dim=-1)
    return pred, target


def lovasz_softmax(probs: torch.Tensor, labels: torch.Tensor, *,
                   num_classes: int,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lovász-softmax (the Lovász extension of the IoU) over flattened
    pixels: probs (..., C) softmax probabilities, labels (...,) int; the
    mean over the classes present of each class's loss. All classes go
    through one sort: each class's errors in descending order, ties to
    the lower index (a stable sort of the negated errors, as the JAX
    package's ``argsort``; the order of tied errors moves the
    gradient). The sort is not additive across ranks: under a data mesh
    every rank gathers the global batch's pixels (with autograd), takes
    the whole term and keeps 1/W of it."""
    probs, labels = all_gather(probs), all_gather(labels)
    if mask is not None:
        mask = all_gather(mask)
    probs = probs.reshape(-1, num_classes)
    labels = labels.reshape(-1)
    valid = labels >= 0
    if mask is not None:
        valid = valid & mask.reshape(-1).bool()
    classes = torch.arange(num_classes, device=labels.device)[:, None]
    fg = ((labels.clamp_min(0)[None] == classes) & valid).to(probs.dtype)
    errors = torch.where(valid, (fg - probs.T).abs(), 0.0)     # (C, P)
    order = torch.sort(-errors.detach(), dim=1, stable=True).indices
    errors_sorted = errors.gather(1, order)
    fg_sorted = fg.gather(1, order)
    valid_sorted = valid.to(probs.dtype)[order]
    gts = fg.sum(1, keepdim=True)
    inter = gts - fg_sorted.cumsum(1)
    union = gts + (valid_sorted - fg_sorted).cumsum(1)
    jaccard = 1.0 - inter / union.clamp_min(1e-6)
    grad = torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], 1)
    present = gts[:, 0] > 0
    losses = torch.where(present, (errors_sorted * grad).sum(1), 0.0)
    return share(losses.sum() / present.sum().clamp_min(1))
