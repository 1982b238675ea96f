"""Spread-accumulate on Hopper: K row streams summed into one dense table.

Replaces the TPU kernel ``lisec_tpu/ops/pallas/spread_kernel.py::
spread_accumulate`` (body ``_spread_kernel``), the engine of the sparse
3D convolution: each of the K kernel offsets routes its product rows to
their output voxels, and all offsets add into one table:

    out[b, t, :] = sum over k = 0..K-1 of vals[b, k, n, :]
                   where targets[b, k, n] == t

``vals`` is (B, K, N, C) bf16 or f32, row-major; ``targets`` is (B, K, N)
int32 and names each row of ``[0, num_out)`` at most once per (b, k)
(collisions across k are the point); any id outside that range drops its
row, so a scatter rulebook goes in with its -1 entries as they are. The
result is (B, num_out, C) f32, zeros where nothing lands.

The TPU kernel's slabs and windows, its one-hot matrix product, the
hi+mid bf16 split of f32 streams, the channel-leading stream layout, the
channel and row padding and the ascending (``cummax``) targets with
zeroed values all serve that machine's in-order grid and matrix unit;
none is carried over, and f32 streams are routed exactly.

Bound on the card: the function reads every id, the values of the rows
that land, and writes the table once: ``4 B K N + landed * C * itemsize
+ 4 B num_out C`` bytes; it does one add per landed row-channel, which is
negligible. It is bound by bytes. ``chip_smoke.py`` computes the bound
from the ids of the run it times.

Design. The accumulate reads an inverse map ``in_of[b, k, t]``, the
row n of ``vals[b, k]`` that lands on t or -1. A caller that holds it
passes it as ``sources`` (a submanifold conv's is its scatter rulebook
with k reversed, built once a level): one launch. Else a small kernel
builds it in scratch without a memset (a block clears its (b, k) slice,
then stores that slice's rows), whatever the scratch held: two
launches. A
warp owns whole output rows (16, 8 or 4 of them at C = 16, 32, 64 bf16,
16 bytes of a value row a lane); it reads its rows' map entries for 32
offsets in one coalesced load a lane and shares them by shuffles, then
loads the landed rows eight offsets at a time and adds them in f32 in k
order, writing once. No atomics on floats: the sum's order is fixed, so
a run repeats bit for bit, and the plain version (one ``index_add_`` per
k, whose targets never collide) gives the same bits. The plain version
ignores ``sources`` and computes from ``targets``.

On a CPU tensor ``spread_accumulate`` computes the plain version
``spread_accumulate_reference``; on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from lisec_tpu_torch.ops.cuda import build

# Launches of the CUDA kernel since import.
LAUNCHES = 0

KERNEL_INFO = {
    "name": "spread_accumulate",
    "route": "cuda",
    "source": "lisec_tpu_torch/csrc/spread_accumulate.cu",
    "replaces": "lisec_tpu/ops/pallas/spread_kernel.py:117",
}


def spread_accumulate_reference(vals: torch.Tensor, targets: torch.Tensor,
                                *, num_out: int,
                                sources: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one f32 ``index_add_`` per k,
    in order, onto a table with one trash row per cloud for the dropped
    rows. It takes ``sources`` as the wrapper does and ignores it: the
    sum comes from ``targets`` alone."""
    b, k, n, c = vals.shape
    dev = vals.device
    ids = torch.where((targets < 0) | (targets >= num_out), num_out,
                      targets).long()
    rows = ids + torch.arange(b, device=dev)[:, None, None] * (num_out + 1)
    out = torch.zeros((b * (num_out + 1), c), dtype=torch.float32,
                      device=dev)
    for kk in range(k):
        out.index_add_(0, rows[:, kk].reshape(-1),
                       vals[:, kk].reshape(b * n, c).float())
    return out.view(b, num_out + 1, c)[:, :num_out].contiguous()


_spread_fn = None


def _bind() -> None:
    """Bind the library's entry point once (every argument one 64-bit
    word)."""
    global _spread_fn
    _spread_fn = build.bind("spread_accumulate", "lisec_spread_accumulate",
                            [ctypes.c_void_p] * 12)


_MAX_ELEMS = 2 ** 31   # the kernel's offsets inside a cloud are 32-bit


def _refuse(vals, targets, num_out, sources):
    """Raise the ValueError that says why ``_check`` refused."""
    if vals.dtype not in (torch.float32, torch.bfloat16) or vals.dim() != 4:
        raise ValueError(f"vals must be (B, K, N, C) float32 or bfloat16, "
                         f"got {tuple(vals.shape)} {vals.dtype}")
    b, k, n, c = vals.shape
    if targets.dtype != torch.int32 or targets.shape != (b, k, n):
        raise ValueError(f"targets must be ({b}, {k}, {n}) int32, got "
                         f"{tuple(targets.shape)} {targets.dtype}")
    if sources is not None and (sources.dtype != torch.int32
                                or sources.shape != (b, k, num_out)):
        raise ValueError(f"sources must be ({b}, {k}, {num_out}) int32, got "
                         f"{tuple(sources.shape)} {sources.dtype}")
    for name, a in (("targets", targets), ("sources", sources)):
        if a is not None and a.device != vals.device:
            raise ValueError(f"{name} is on {a.device}, vals on "
                             f"{vals.device}")
    if min(b, k, n, c, num_out) < 1:
        raise ValueError(f"need B, K, N, C, num_out >= 1, got {b}, {k}, "
                         f"{n}, {c}, {num_out}")
    if (b > 65535 or k * n * c >= _MAX_ELEMS or k * num_out >= _MAX_ELEMS
            or num_out * c >= _MAX_ELEMS):
        raise ValueError("the kernel's grid or its 32-bit offsets cannot "
                         "cover this table")
    raise ValueError("vals, targets and sources must be contiguous")


def _check(vals, targets, num_out, sources):
    if not (vals.dtype in (torch.float32, torch.bfloat16)
            and targets.dtype == torch.int32 and vals.dim() == 4
            and targets.shape == vals.shape[:3] and vals.numel() > 0
            and num_out >= 1 and vals.is_contiguous()
            and targets.is_contiguous()
            and targets.get_device() == vals.get_device()
            and vals.shape[0] <= 65535
            and vals.numel() < _MAX_ELEMS * vals.shape[0]
            and vals.shape[1] * num_out < _MAX_ELEMS
            and num_out * vals.shape[3] < _MAX_ELEMS
            and (sources is None or (
                sources.dtype == torch.int32
                and sources.shape == (*vals.shape[:2], num_out)
                and sources.is_contiguous()
                and sources.device == vals.device))):
        _refuse(vals, targets, num_out, sources)


def spread_accumulate(vals: torch.Tensor, targets: torch.Tensor, *,
                      num_out: int,
                      sources: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """(B, num_out, C) f32 table: row ``targets[b, k, n]`` takes the sum
    over k, in order, of ``vals[b, k, n]``; ids outside ``[0, num_out)``
    drop their row. Per (b, k) the ids inside the range must be distinct.
    ``sources`` (B, K, num_out) int32, where the caller holds it, is the
    inverse map (``sources[b, k, t]`` the n with ``targets[b, k, n] ==
    t``, else -1): the kernel then reads it instead of building one. A
    CPU tensor takes the plain version (which ignores ``sources``); a
    CUDA tensor launches the kernel."""
    global LAUNCHES
    _check(vals, targets, num_out, sources)
    if not vals.is_cuda:
        return spread_accumulate_reference(vals, targets, num_out=num_out)
    b, k, n, c = vals.shape
    if _spread_fn is None:
        _bind()
    in_of = (vals.new_empty(b, k, num_out, dtype=torch.int32)
             if sources is None else sources)
    out = vals.new_empty(b, num_out, c, dtype=torch.float32)
    err = _spread_fn(
        vals.data_ptr(), targets.data_ptr(), in_of.data_ptr(),
        out.data_ptr(), b, k, n, c, num_out,
        vals.dtype == torch.bfloat16, sources is not None,
        build.stream_of(vals))
    if err != 0:
        raise RuntimeError(
            f"spread_accumulate kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
