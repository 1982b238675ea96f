"""The int16 wire format for point batches (port of
``lisec_tpu/data/wire.py``).

A padded f32 batch crosses to the card as 16 bytes a point plus a (B, N)
bool mask. The wire sends instead

* the points as int16 fixed-point codes against per-channel bounds taken
  from the batch's valid points (for KITTI's spans of at most about 80 m
  the rounding error is below 80 / 65535 / 2, about 0.6 mm, far below a
  lidar's noise and a pillar's 0.16 m);
* a (B,) int32 count in place of the mask: padded batches are
  prefix-valid (``pack_points_q16`` compacts a mask that is not), and the
  card rebuilds the mask with an arange compare.

Quantisation is for the wire only: ``unpack_points_q16`` dequantizes to
f32 on the card before the pipeline's predict, and every other path
keeps the exact f32 points.

``pack_points_q16`` runs on the host in compiled C++
(``lisec_tpu_torch/csrc/wire_pack.cc``, built with ``g++`` at the first
pack): one pass over each cloud's valid rows takes the bounds, a second
writes the codes (compacting a mask that is not a prefix) and the
padding, where the JAX package's numpy makes about ten passes over the
whole padded batch. Its results equal that numpy pack's bit for bit:
each step is the same single IEEE f32 operation (a true division, ties
of the rounding to even, no fused multiply-add), and the bounds are a
minimum and a maximum, whose order of visiting does not matter.
``unpack_points_q16`` is torch and runs where its tensors lie. Its
arithmetic follows the JAX package's jitted program bit for bit: XLA on
the CPU contracts ``(q + 32768) * scale + lo`` into one fused
multiply-add and treats subnormal floats as zero, while torch rounds the
product and the sum apart (an ulp that moves a point across a pillar
edge). So the product is taken exactly in f64 (17 by 24 bits), the sum
rounded to f64 with its error kept (Knuth's two-sum) and made odd where
inexact, which makes the one rounding to f32 that of a fused
multiply-add; subnormal bounds and results become zero, as there. Every
step is an IEEE f64 or f32 operation, so the card's result equals the
CPU's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch

from lisec_tpu_torch.ops.cuda import build
from lisec_tpu_torch.utils.profiling import span

WIRE_LEVELS = 65535  # int16 full scale

_WIRE_KEYS = ("points_q16", "num_points", "wire_lo", "wire_scale")
_F32_TINY = float(np.finfo(np.float32).tiny)


@functools.lru_cache(maxsize=None)
def _pack_entry():
    """The C entry point of ``csrc/wire_pack.cc``, built and bound at the
    first pack."""
    build.build("wire_pack")
    fn = ctypes.CDLL(str(build.library_path("wire_pack"))).lisec_wire_pack_q16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = None
    return fn


def pack_points_q16(points: np.ndarray,
                    point_mask: np.ndarray) -> Dict[str, np.ndarray]:
    """Quantize a padded (B, N, C) f32 batch to the int16 wire format.

    Returns a dict:
      points_q16  (B, N, C) int16 — fixed-point codes
      num_points  (B,)      int32 — valid prefix length per cloud
      wire_lo     (C,)      f32   — per-channel dequant offset
      wire_scale  (C,)      f32   — per-channel dequant step

    Padding slots take code -32768 (they decode to ``wire_lo`` and are
    masked out on the card). Under a profiler, the span ``wire.pack``.
    """
    with span("wire.pack"):
        points = np.ascontiguousarray(points, np.float32)
        mask = np.ascontiguousarray(point_mask, bool)
        if points.ndim != 3:
            raise ValueError(f"expected (B, N, C) points, got {points.shape}")
        b, n, c = points.shape
        if mask.shape != (b, n):
            raise ValueError(f"expected a ({b}, {n}) mask, got {mask.shape}")
        out = {"points_q16": np.empty((b, n, c), np.int16),
               "num_points": np.empty((b,), np.int32),
               "wire_lo": np.empty((c,), np.float32),
               "wire_scale": np.empty((c,), np.float32)}
        _pack_entry()(points.ctypes.data, mask.ctypes.data, b, n, c,
                      *(v.ctypes.data for v in out.values()))
        return out


def _flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """Subnormal f32 values to a zero of their sign."""
    return torch.where(x.abs() < _F32_TINY, x * 0, x)


def dequantize(q: torch.Tensor, lo: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """``(q + 32768) * scale + lo`` (f32) with one rounding, as a fused
    multiply-add rounds, subnormal inputs and outputs taken as zero."""
    p = (q.double() + 32768.0) * _flush_subnormal(scale.float()).double()
    c = _flush_subnormal(lo.float()).double()
    s = p + c
    r = s - p
    err = (p - (s - r)) + (c - r)
    # Round to odd: an inexact f64 sum steps one ulp towards the exact
    # value where its last bit is even, so the f32 rounding below sees
    # which side of a tie the exact sum lies on.
    step = torch.where(err > 0, torch.inf, -torch.inf).double()
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even, torch.nextafter(s, step), s)
    return _flush_subnormal(s.float())


def unpack_points_q16(packed: Dict) -> Dict:
    """Dequantize on the tensors' device: ``{"points": (B, N, C) f32,
    "point_mask": (B, N) bool}`` plus every other key of ``packed``, as
    it is."""
    q = packed["points_q16"]
    counts = packed["num_points"]
    out = {k: v for k, v in packed.items() if k not in _WIRE_KEYS}
    out["points"] = dequantize(q, packed["wire_lo"], packed["wire_scale"])
    n = q.shape[1]
    out["point_mask"] = (torch.arange(n, dtype=counts.dtype,
                                      device=counts.device)[None, :]
                         < counts[:, None])
    return out
