"""Faults planted in the reference put in the program's place, for the
readings that the limits of ``correct`` are set from: the configuration
with NMS that suppresses nothing, or with no score threshold."""

from __future__ import annotations

import copy
from typing import Dict

PLANTED = {
    "nms_off": {"nms_iou": 1.01},
    "threshold_ignored": {"score_threshold": -1.0},
}


def planted(cfg: Dict, name: str) -> Dict:
    """A copy of the program configuration ``cfg`` with fault ``name``."""
    out = copy.deepcopy(cfg)
    out["model"]["params"].update(PLANTED[name])
    return out
