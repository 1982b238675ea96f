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

Design (simple first): a first small kernel writes the inverse map
``in_of[b, k, t] = n`` (-1 where nothing lands; the scratch is B K
num_out ints), a second has one owner thread per VEC output channels
that walks k in order, adds the row that lands there in f32 and writes
once. No atomics on floats: the sum's order is fixed, so a run repeats
bit for bit, and the plain version (one ``index_add_`` per k, whose
targets never collide) gives the same bits.

On a CPU tensor ``spread_accumulate`` computes the plain version
``spread_accumulate_reference``; on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

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
                                *, num_out: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one f32 ``index_add_`` per k,
    in order, onto a table with one trash row per cloud for the dropped
    rows."""
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


def _library() -> ctypes.CDLL:
    lib = build.load("spread_accumulate")
    fn = lib.lisec_spread_accumulate
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _check(vals, targets, num_out):
    if vals.dtype not in (torch.float32, torch.bfloat16) or vals.dim() != 4:
        raise ValueError(f"vals must be (B, K, N, C) float32 or bfloat16, "
                         f"got {tuple(vals.shape)} {vals.dtype}")
    b, k, n, c = vals.shape
    if targets.dtype != torch.int32 or targets.shape != (b, k, n):
        raise ValueError(f"targets must be ({b}, {k}, {n}) int32, got "
                         f"{tuple(targets.shape)} {targets.dtype}")
    if targets.device != vals.device:
        raise ValueError(f"targets is on {targets.device}, vals on "
                         f"{vals.device}")
    if min(b, k, n, c, num_out) < 1:
        raise ValueError(f"need B, K, N, C, num_out >= 1, got {b}, {k}, "
                         f"{n}, {c}, {num_out}")
    if num_out * c >= 2 ** 31 or b > 65535:
        raise ValueError("the kernel's grid cannot cover this table")
    for name, a in (("vals", vals), ("targets", targets)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def spread_accumulate(vals: torch.Tensor, targets: torch.Tensor, *,
                      num_out: int) -> torch.Tensor:
    """(B, num_out, C) f32 table: row ``targets[b, k, n]`` takes the sum
    over k, in order, of ``vals[b, k, n]``; ids outside ``[0, num_out)``
    drop their row. Per (b, k) the ids inside the range must be distinct.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel."""
    global LAUNCHES
    _check(vals, targets, num_out)
    if vals.device.type == "cpu":
        return spread_accumulate_reference(vals, targets, num_out=num_out)
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    b, k, n, c = vals.shape
    in_of = torch.empty((b, k, num_out), dtype=torch.int32,
                        device=vals.device)
    out = torch.empty((b, num_out, c), dtype=torch.float32,
                      device=vals.device)
    err = _library().lisec_spread_accumulate(
        vals.data_ptr(), targets.data_ptr(), in_of.data_ptr(),
        out.data_ptr(), b, k, n, c, num_out,
        int(vals.dtype == torch.bfloat16),
        torch.cuda.current_stream(vals.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"spread_accumulate kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
