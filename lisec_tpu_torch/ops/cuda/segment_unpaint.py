"""Segment unpaint on Hopper: per-row gather from a dense per-cell table.

Replaces the TPU kernel ``lisec_tpu/ops/pallas/unpaint.py::
segment_unpaint`` (body ``_unpaint_kernel``):

    out[b, i] = table[b, cell[b, i]]        zeros where cell is no row

for ``table`` (B, R, C) f32 and ids ``cell`` (B, N) int32. It is a pure
gather, so it is bit-exact (the TPU kernel's default mode returns a
two-term bf16 reconstruction; this one never does).

The TPU kernel writes aligned windows that overrun into the neighbouring
ranges, relies on its grid steps running one after another to overwrite
them, and patches the range starts afterwards. CUDA blocks run in no
order, so here every output element has one owner thread that writes it
exactly once, the zero rows of invalid ids included; the output comes
from ``new_empty`` and nothing is patched.

Bound on the card: it reads the ids, at most one table row per output
row, and writes the output once: ``B * N * (8 C + 4)`` bytes, no
arithmetic. For the segment-max backward (N = 32,768, C = 64) that is
16.9 MB per cloud and table, about 5 us at 3.35 TB/s; bound by bytes.

Table and ids are contiguous. Ids need not be sorted for the result to
be right (sorted ids make the reads local).

On a CPU tensor ``segment_unpaint`` computes the plain version
``segment_unpaint_reference``; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from lisec_tpu_torch.ops.cuda import build

# Launches of the CUDA kernel since import.
LAUNCHES = 0

KERNEL_INFO = {
    "name": "segment_unpaint",
    "route": "cuda",
    "source": "lisec_tpu_torch/csrc/segment_unpaint.cu",
    "replaces": "lisec_tpu/ops/pallas/unpaint.py:131",
}


def segment_unpaint_reference(table: torch.Tensor,
                              cell_sorted: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``torch.gather`` with a zero
    mask."""
    r, c = table.shape[1:]
    ok = (cell_sorted >= 0) & (cell_sorted < r)
    idx = torch.where(ok, cell_sorted, 0).long()
    out = torch.gather(table, 1, idx[..., None].expand(-1, -1, c))
    return torch.where(ok[..., None], out, 0.0)


_unpaint_fn = None


def _check(table, cell_sorted):
    if table.dtype != torch.float32 or table.dim() != 3:
        raise ValueError(f"table must be (B, R, C) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    b, r, c = table.shape
    if cell_sorted.dtype != torch.int32 or cell_sorted.dim() != 2 \
            or cell_sorted.shape[0] != b:
        raise ValueError(f"cell_sorted must be ({b}, N) int32, got "
                         f"{tuple(cell_sorted.shape)} {cell_sorted.dtype}")
    if cell_sorted.device != table.device:
        raise ValueError(f"cell_sorted is on {cell_sorted.device}, table on "
                         f"{table.device}")
    n = cell_sorted.shape[1]
    if min(b, r, c, n) < 1:
        raise ValueError(f"need B, R, C, N >= 1, got {b}, {r}, {c}, {n}")
    if b * n * c >= 2 ** 31 * 256:
        raise ValueError("the kernel's grid cannot cover this output")
    for name, a in (("table", table), ("cell_sorted", cell_sorted)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def segment_unpaint(table: torch.Tensor, cell_sorted: torch.Tensor
                    ) -> torch.Tensor:
    """Per-row table rows (B, N, C) f32: ``out[b, i] = table[b, cell[b,
    i]]``, zeros where the id is negative or >= R. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel."""
    global LAUNCHES, _unpaint_fn
    _check(table, cell_sorted)
    if table.device.type == "cpu":
        return segment_unpaint_reference(table, cell_sorted)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    b, r, c = table.shape
    n = cell_sorted.shape[1]
    if _unpaint_fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _unpaint_fn = build.bind("segment_unpaint", "lisec_segment_unpaint",
                                 [p, p, p, i, i, i, i, p])
    out = table.new_empty((b, n, c))
    err = _unpaint_fn(table.data_ptr(), cell_sorted.data_ptr(),
                      out.data_ptr(), b, n, r, c, build.stream_of(table))
    if err != 0:
        raise RuntimeError(
            f"segment_unpaint kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
