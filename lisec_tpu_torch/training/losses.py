"""Detection losses (port of ``sigmoid_focal_loss``, ``smooth_l1`` and
``sin_difference`` from ``lisec_tpu/training/losses.py``): focal loss
(alpha 0.25, gamma 2), smooth-L1 with SECOND's sin-difference angle
trick. The other workloads' losses come with those workloads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
