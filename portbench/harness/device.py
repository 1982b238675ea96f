"""The cards a run uses: the check that they are there, and the
``device`` field of the result."""

from __future__ import annotations

import subprocess
from typing import Dict

import torch


class NoCard(RuntimeError):
    """Fewer cards than the cell asks for; the run prints no result."""


def require_cards(n: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False")
    have = torch.cuda.device_count()
    if have < n:
        raise NoCard(f"the cell asks for {n} cards, {have} present")


def power_limit_w() -> str:
    """The card's power limit as ``nvidia-smi`` reports it (the card may be
    set below its 700 W, which slows it under load)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread: {e.__class__.__name__}"
    return out.strip().splitlines()[0].strip() if out.strip() else "unread"


def describe(count: int, memory_peak_bytes: int) -> Dict:
    """The result's ``device``: a CUDA card, named as torch names it."""
    return {"platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": int(count),
            "memory_peak_bytes": int(memory_peak_bytes),
            "power_limit_w": power_limit_w()}
