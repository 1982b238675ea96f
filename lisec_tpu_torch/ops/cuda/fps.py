"""Farthest-point sampling on Hopper.

Replaces the TPU kernel ``lisec_tpu/ops/pallas/fps_kernel.py::fps_pallas``
(bodies ``_fps_batched_kernel`` and ``_fps_kernel``). For points (B, N, 3)
f32 and a mask (B, N) bool it returns (B, M) int32 indices:

* the seed is the first valid point, or 0 when the cloud has none;
* then M - 1 rounds: every valid point's running distance becomes the
  min of itself and its squared distance to the last pick, summed as
  ``(dx*dx + dy*dy) + dz*dz`` with every step rounded, and the next pick
  is the argmax, the lowest index winning a tie. Masked points hold
  -3e38 and are never picked; once every valid point is picked, the
  picks repeat the lowest-index valid point at distance 0, as in the
  reference.

Design (``csrc/fps.cu``): one thread block per cloud keeps the cloud's
xyz and its running distances in shared memory for all M rounds (16
bytes a point, so N up to 14,336); a round is an update pass, a
warp-shuffle argmax on (value, index) pairs and one pass across the
warps. The distance is written with ``__fsub_rn``, ``__fmul_rn`` and
``__fadd_rn``, so nvcc cannot contract it into FMAs, which would move
one ulp and with it an argmax and every later pick.

Bound on the card: about 10 f32 operations per valid point per round
(three subtractions, three products, two sums, a min and a compare):
``16 * 2048 * 511 * 10 / 67 TFLOP/s``, about 2.5 us for PointNet++'s SA1
at batch 16; the bytes (points, mask, picks) are less. The kernel sits
far above that: its M rounds are sequential, so it is held by the
latency of M block-wide reductions, with 16 of the card's 132 SMs busy.

On a CPU tensor ``fps`` computes the plain version ``fps_reference``; on
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from lisec_tpu_torch.ops.cuda import build

# Launches of the CUDA kernel since import.
LAUNCHES = 0

KERNEL_INFO = {
    "name": "fps",
    "route": "cuda",
    "source": "lisec_tpu_torch/csrc/fps.cu",
    "replaces": "lisec_tpu/ops/pallas/fps_kernel.py:126",
}

# The most points per cloud the kernel's shared memory holds
# (``lisec_fps_max_points`` in the source).
MAX_POINTS = 14336

_NEG = -3.0e38


def fps_reference(points: torch.Tensor, mask: torch.Tensor,
                  num_samples: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in the kernel's arithmetic:
    M - 1 rounds of (B, N) tensor operations."""
    b, n, _ = points.shape
    dev = points.device
    lane = torch.arange(n, device=dev)
    first = torch.where(mask, lane, n).min(dim=1).values
    last = torch.where(first < n, first, 0)
    out = torch.zeros((b, num_samples), dtype=torch.int32, device=dev)
    out[:, 0] = last
    dist = torch.where(mask, 3.0e38, _NEG)
    xs, ys, zs = points.unbind(-1)
    for i in range(1, num_samples):
        sel = last[:, None]
        dx = xs - xs.gather(1, sel)
        dy = ys - ys.gather(1, sel)
        dz = zs - zs.gather(1, sel)
        d2 = (dx * dx + dy * dy) + dz * dz
        dist = torch.minimum(dist, torch.where(mask, d2, _NEG))
        top = dist.max(dim=1, keepdim=True).values
        last = torch.where(dist >= top, lane, n).min(dim=1).values
        out[:, i] = last
    return out


_fps_fn = None


def _check(points, mask, num_samples):
    if points.dtype != torch.float32 or points.dim() != 3 \
            or points.shape[2] != 3:
        raise ValueError(f"points must be (B, N, 3) float32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    b, n, _ = points.shape
    if mask.dtype != torch.bool or mask.shape != (b, n):
        raise ValueError(f"mask must be ({b}, {n}) bool, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if mask.device != points.device:
        raise ValueError(f"mask is on {mask.device}, points on "
                         f"{points.device}")
    if min(b, n, num_samples) < 1:
        raise ValueError(f"need B, N, M >= 1, got {b}, {n}, {num_samples}")
    if n > MAX_POINTS:
        raise ValueError(f"{n} points per cloud: the kernel holds at most "
                         f"{MAX_POINTS} in shared memory")
    for name, a in (("points", points), ("mask", mask)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fps(points: torch.Tensor, mask: torch.Tensor,
        num_samples: int) -> torch.Tensor:
    """(B, M) int32 farthest-point picks of points (B, N, 3) f32 under a
    (B, N) bool mask. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    global LAUNCHES, _fps_fn
    _check(points, mask, num_samples)
    if points.device.type == "cpu":
        return fps_reference(points, mask, num_samples)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    b, n, _ = points.shape
    if _fps_fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _fps_fn = build.bind("fps", "lisec_fps", [p, p, p, i, i, i, p])
    out = points.new_empty((b, num_samples), dtype=torch.int32)
    err = _fps_fn(points.data_ptr(), mask.data_ptr(), out.data_ptr(), b, n,
                  num_samples, build.stream_of(points))
    if err != 0:
        raise RuntimeError(f"fps kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
