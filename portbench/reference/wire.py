"""The int16 wire, worked out again for the reference.

``pack_q16`` is a frozen copy of the arithmetic of the port's
``data/wire.py::pack_points_q16`` (numpy on the host: per-channel bounds
over the batch's valid points, codes ``rint((p - lo) / scale) - 32768``),
so that the reference sees the points that the served request carried.
``dequantize`` computes ``(q + 32768) * scale + lo`` in float64 and rounds
once to float32, which is the one rounding of a fused multiply-add but
for ties of the double rounding, a few points in a billion at most.
"""

from __future__ import annotations

import numpy as np
import torch

LEVELS = 65535


def pack_q16(points: np.ndarray, counts: np.ndarray):
    """(B, N, C) float32 points whose first ``counts[b]`` rows are valid
    -> (codes (B, N, C) int16, lo (C,) f32, scale (C,) f32)."""
    points = np.asarray(points, np.float32)
    b, n, c = points.shape
    valid = np.arange(n)[None, :] < np.asarray(counts)[:, None]
    if valid.any():
        lo = np.where(valid[..., None], points, np.inf).min(axis=(0, 1))
        hi = np.where(valid[..., None], points, -np.inf).max(axis=(0, 1))
    else:
        lo = np.zeros((c,), np.float32)
        hi = np.ones((c,), np.float32)
    lo = lo.astype(np.float32)
    span = np.maximum((hi - lo).astype(np.float32), 1e-6)
    scale = (span / LEVELS).astype(np.float32)
    q = np.rint((points - lo) / scale) - 32768.0
    q = np.clip(q, -32768, 32767).astype(np.int16)
    q[~valid] = -32768
    return q, lo, scale


def dequantize(q: np.ndarray, lo: np.ndarray, scale: np.ndarray,
               device) -> torch.Tensor:
    """Codes back to float32 points on ``device``."""
    q = torch.as_tensor(q, device=device).double()
    s = torch.as_tensor(scale, device=device).double()
    o = torch.as_tensor(lo, device=device).double()
    return ((q + 32768.0) * s + o).float()
