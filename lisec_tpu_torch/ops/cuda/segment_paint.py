"""Segment paint on Hopper: cell-sorted rows -> dense per-cell table.

Replaces the TPU kernel ``lisec_tpu/ops/pallas/pillar_paint.py::
segment_paint`` (body ``_paint_kernel``). For rows ``vals`` (B, N, C) f32
sorted by ``cell_sorted`` (B, N) ascending it returns the (B, num_cells,
C) f32 table with

* channels ``[0, num_max)``: the per-cell max, -3e38 where the cell is
  empty (callers test ``> -1e38`` or a count);
* channels ``[num_max, C)``: the per-cell sum, 0 where empty. A caller
  that needs the count carries a channel of ones.

With ``split`` the table comes out in two contiguous parts, channels
``[0, split)`` and ``[split, C)``: a caller's canvas and its count
channel as two dense tensors, with no strided view between them.

Rows whose id is negative or >= ``num_cells`` are dropped. The function
is exact f32 and takes any C: the TPU kernel's slab and window sizes, its
bf16 routing passes and ``exact`` flag, its ``count_channel`` and its
channel padding to a multiple of 8 are devices of that machine and are
not carried over.

Bound on the card: the function reads every id, the values of the rows
it places (a dropped row's values are never needed) and writes the table
once, ``B * (4 N + num_cells * 4 C) + placed * 4 C`` bytes; it does one
compare or add per placed row-channel, which is negligible. At the
training shapes (214,272 cells, 32,768 points) the segment max (C = 65)
writes 55.7 MB per cloud and reads at most 8.7 MB, about 19 us at 3.35
TB/s; the encoder statistics (C = 4) move at most 4.1 MB and the
assigner's table (107,136 anchors, 131,072 rows, C = 3) at most 3.4 MB.
All are bound by bytes, mostly the table write. ``chip_smoke.py``
computes the bound from the ids of the run it times.

Design: one launch, no glue (no ``searchsorted`` in torch). A block owns
a tile of consecutive cells of one cloud (up to 1024; fewer for wide
tables, and fewer where the grid would leave multiprocessors idle). Two
of its warps find the tile's rows with a 32-way search of the sorted ids,
clamped to ``num_cells`` as they are read (so an invalid tail need not be
sorted within itself, and negative ids at the head sort before every
cell); the block walks those rows once and marks in shared memory where
each of its cells starts. The tile's rows are one contiguous run of
``vals``: the block stages it through shared memory a piece at a time,
and owner threads fold each row into their cell's running max or f64
sum from there, in row order, carrying a cell into the next piece (a
near-range pillar holds over 200 points, and its owner's chain of
additions then waits on shared memory, not device memory). Every
element is written once, empty cells included: four channels of one
cell a thread, stored as one 16-byte vector, where the part's width is a
multiple of 4 (a warp stores 512 contiguous bytes), else one channel a
thread (the count channel of ``split``: one coalesced float a cell). A
thread's cells and channels follow from the tile, with no division per
element. No atomics: sums are taken in row order in f64 and rounded
once, as before, so a run repeats bit for bit and equals the plain
version.

On a CPU tensor ``segment_paint`` computes the plain version
``segment_paint_reference``; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from lisec_tpu_torch.ops.cuda import build

Table = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]

# Launches of the CUDA kernel since import.
LAUNCHES = 0

KERNEL_INFO = {
    "name": "segment_paint",
    "route": "cuda",
    "source": "lisec_tpu_torch/csrc/segment_paint.cu",
    "replaces": "lisec_tpu/ops/pallas/pillar_paint.py:186",
}

EMPTY_MAX = -3.0e38


def segment_paint_reference(vals: torch.Tensor, cell_sorted: torch.Tensor,
                            *, num_cells: int, num_max: int,
                            split: Optional[int] = None) -> Table:
    """Plain PyTorch version of the kernel: a scatter max and an f64
    ``index_add_`` (rounded to f32 once, as the kernel rounds) onto a
    table with one trash row per cloud for the dropped rows."""
    b, n, c = vals.shape
    dev = vals.device
    ids = torch.where((cell_sorted < 0) | (cell_sorted >= num_cells),
                      num_cells, cell_sorted).long()
    rows = (ids + torch.arange(b, device=dev)[:, None]
            * (num_cells + 1)).reshape(-1)
    flat = vals.reshape(b * n, c)
    parts = []
    if num_max:
        mx = torch.full((b * (num_cells + 1), num_max), EMPTY_MAX,
                        device=dev).scatter_reduce_(
            0, rows[:, None].expand(-1, num_max), flat[:, :num_max], "amax",
            include_self=True)
        parts.append(mx)
    if c > num_max:
        sm = torch.zeros((b * (num_cells + 1), c - num_max),
                         dtype=torch.float64, device=dev).index_add_(
            0, rows, flat[:, num_max:].double())
        parts.append(sm.float())
    out = torch.cat(parts, -1) if len(parts) > 1 else parts[0]
    out = out.view(b, num_cells + 1, c)[:, :num_cells]
    if split is None:
        return out.contiguous()
    return out[..., :split].contiguous(), out[..., split:].contiguous()


def _library() -> ctypes.CDLL:
    lib = build.load("segment_paint")
    fn = lib.lisec_segment_paint
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _check(vals, cell_sorted, num_cells, num_max, split):
    if vals.dtype != torch.float32 or vals.dim() != 3:
        raise ValueError(f"vals must be (B, N, C) float32, got "
                         f"{tuple(vals.shape)} {vals.dtype}")
    b, n, c = vals.shape
    if cell_sorted.dtype != torch.int32 or cell_sorted.shape != (b, n):
        raise ValueError(f"cell_sorted must be ({b}, {n}) int32, got "
                         f"{tuple(cell_sorted.shape)} {cell_sorted.dtype}")
    if (cell_sorted.get_device() != vals.get_device()
            or cell_sorted.is_cuda != vals.is_cuda):
        raise ValueError(f"cell_sorted is on {cell_sorted.device}, vals on "
                         f"{vals.device}")
    if b < 1 or c < 1 or num_cells < 1 or not 0 <= num_max <= c:
        raise ValueError(f"need B, C, num_cells >= 1 and 0 <= num_max <= C, "
                         f"got B={b} C={c} num_cells={num_cells} "
                         f"num_max={num_max}")
    if split is not None and not 0 < split < c:
        raise ValueError(f"need 0 < split < C, got split={split} C={c}")
    if num_cells * c >= 2 ** 31:
        raise ValueError("the kernel's grid cannot cover this table")
    if not (vals.is_contiguous() and cell_sorted.is_contiguous()):
        raise ValueError("vals and cell_sorted must be contiguous")
    if not (vals.is_cuda or vals.is_cpu):
        raise ValueError(f"unsupported device {vals.device}")


def segment_paint(vals: torch.Tensor, cell_sorted: torch.Tensor, *,
                  num_cells: int, num_max: int,
                  split: Optional[int] = None) -> Table:
    """Dense per-cell reduction table (B, num_cells, C) f32 of rows sorted
    by cell: max over channels ``[0, num_max)``, sum over the rest; with
    ``split``, the pair of its channels ``[0, split)`` and ``[split, C)``,
    each contiguous. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    global LAUNCHES
    _check(vals, cell_sorted, num_cells, num_max, split)
    if not vals.is_cuda:
        return segment_paint_reference(vals, cell_sorted,
                                       num_cells=num_cells, num_max=num_max,
                                       split=split)
    b, n, c = vals.shape
    out = vals.new_empty((b, num_cells, c if split is None else split))
    tail = None if split is None else vals.new_empty(
        (b, num_cells, c - split))
    err = _library().lisec_segment_paint(
        vals.data_ptr(), cell_sorted.data_ptr(), out.data_ptr(),
        None if tail is None else tail.data_ptr(), b, n, num_cells, c,
        num_max, out.shape[2], build.stream_of(vals))
    if err != 0:
        raise RuntimeError(
            f"segment_paint kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out if tail is None else (out, tail)
