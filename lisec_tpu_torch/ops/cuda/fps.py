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

Design (``csrc/fps.cu``), for the latency of one round, since the
rounds are sequential: one block per cloud; for N <= 2048 a block of
256 threads keeps each thread's points (x, y, z and running distance)
in registers for all M rounds, above that (N up to 14,336) the points
sit in shared memory under 1024 threads. A point's key is
``valid ? bits(dist) + 1 : 0`` (valid distances are >= 0, so their bits
order as unsigned ints). On the register route a thread owns a run of
consecutive points, so a warp's winner is a ``redux`` max of the key
and the first lane holding it (a ballot); the shared route takes a
``redux`` min of the index over those lanes. Each warp writes its
winner into a slot double-buffered by round parity, and after the
round's one barrier every thread reduces the slots itself. The
distance is written with ``__fsub_rn``, ``__fmul_rn`` and ``__fadd_rn``,
so nvcc cannot contract it into FMAs, which would move one ulp and with
it an argmax and every later pick. ``fps_gather`` has the same kernel
write the picked points' xyz and mask too (the winner's key says
whether it is valid), which saves the caller a gather of each.

Bound on the card: about 10 f32 operations per valid point per round
(three subtractions, three products, two sums, a min and a compare):
``16 * 2048 * 511 * 10 / 67 TFLOP/s``, about 2.5 us for PointNet++'s SA1
at batch 16; the bytes (points, mask, picks) are less. The kernel sits
far above that: its M rounds are sequential, so it is held by the
latency of M block-wide reductions, with 16 of the card's 132 SMs busy.
``round_floor`` runs those M reductions and barriers alone, at the
same block shape, to show how far a round is from that.

On a CPU tensor ``fps`` and ``fps_gather`` compute the plain versions
``fps_reference`` and ``fps_gather_reference``; on a CUDA tensor they
launch the kernel or raise.
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

# The most points per cloud the kernel's shared-memory route holds
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


def _launch(points, mask, num_samples, out_xyz, out_mask):
    """Launch the kernel on checked CUDA tensors; returns the picks."""
    global LAUNCHES, _fps_fn
    b, n, _ = points.shape
    if _fps_fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _fps_fn = build.bind("fps", "lisec_fps",
                             [p, p, p, p, p, i, i, i, p])
    out = points.new_empty((b, num_samples), dtype=torch.int32)
    err = _fps_fn(points.data_ptr(), mask.data_ptr(), out.data_ptr(),
                  None if out_xyz is None else out_xyz.data_ptr(),
                  None if out_mask is None else out_mask.data_ptr(),
                  b, n, num_samples, build.stream_of(points))
    if err != 0:
        raise RuntimeError(f"fps kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def _device(points):
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {points.device}")
    return points.device.type


def fps(points: torch.Tensor, mask: torch.Tensor,
        num_samples: int) -> torch.Tensor:
    """(B, M) int32 farthest-point picks of points (B, N, 3) f32 under a
    (B, N) bool mask. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    _check(points, mask, num_samples)
    if _device(points) == "cpu":
        return fps_reference(points, mask, num_samples)
    return _launch(points, mask, num_samples, None, None)


def fps_gather_reference(points: torch.Tensor, mask: torch.Tensor,
                         num_samples: int):
    """Plain version of ``fps_gather``: ``fps_reference``, then a gather
    of the picked rows and mask entries."""
    idx = fps_reference(points, mask, num_samples)
    sel = idx.long()
    new_xyz = torch.gather(points, 1, sel[..., None].expand(-1, -1, 3))
    return idx, new_xyz, torch.gather(mask, 1, sel)


def fps_gather(points: torch.Tensor, mask: torch.Tensor, num_samples: int):
    """Farthest-point picks with the picked points: (idx (B, M) int32,
    new_xyz (B, M, 3) f32, new_mask (B, M) bool), one kernel launch on a
    CUDA tensor. The xyz of a cloud carries no gradient on either route,
    so points that require one are refused."""
    _check(points, mask, num_samples)
    if points.requires_grad:
        raise ValueError("fps_gather: the points require a gradient, which "
                         "the picked xyz would not carry")
    if _device(points) == "cpu":
        return fps_gather_reference(points, mask, num_samples)
    b = points.shape[0]
    new_xyz = points.new_empty((b, num_samples, 3))
    new_mask = mask.new_empty((b, num_samples))
    idx = _launch(points, mask, num_samples, new_xyz, new_mask)
    return idx, new_xyz, new_mask


_floor_fn = None


def round_floor(b: int, n: int, num_samples: int,
                device="cuda") -> torch.Tensor:
    """Launch the round floor at fps's block shape for (b, n, M): M rounds
    of the block reduction and its barrier alone (a measurement of what
    the recurrence allows, not counted in ``LAUNCHES``). Returns its
    (B, M) int32 output, which means nothing."""
    global _floor_fn
    if min(b, n, num_samples) < 1 or n > MAX_POINTS:
        raise ValueError(f"round_floor: bad shape {b}, {n}, {num_samples}")
    if _floor_fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _floor_fn = build.bind("fps", "lisec_fps_round_floor",
                               [p, i, i, i, p])
    out = torch.empty((b, num_samples), dtype=torch.int32, device=device)
    err = _floor_fn(out.data_ptr(), b, n, num_samples, build.stream_of(out))
    if err != 0:
        raise RuntimeError(f"fps round floor launch failed: cudaError {err}")
    return out
