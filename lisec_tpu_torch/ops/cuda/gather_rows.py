"""Row gather and its transpose, an ordered row scatter-add, on Hopper.

Replaces the TPU kernels ``lisec_tpu/ops/pallas/gather_mxu.py::
gather_rows_mxu`` (body ``_gather_kernel``) and ``scatter_rows_mxu``
(body ``_scatter_kernel``), and their custom VJP ``gather_rows`` with the
``autograd.Function`` :class:`GatherRows`:

* gather: ``out[b, m] = src[b, idx[b, m]]`` for src (B, N, C) f32 or
  bf16 and idx (B, M) int32; an id outside ``[0, N)`` gives a zero row.
  (B, M, C) in src's type.
* scatter: ``out[b, n] = sum of vals[b, m] over m with idx[b, m] = n``
  for vals (B, M, C) f32; duplicates accumulate, in m order; ids outside
  ``[0, num_rows)`` are dropped. (B, num_rows, C) f32.

The TPU kernels route rows through one-hot matrix products, pad M to
their tile and split an f32 table into two bf16 terms (2^-17 relative);
none of that is carried over. Here the gather copies bits and is exact
in both types, and the scatter adds in f32 in m order.

Design (``csrc/gather_rows.cu``). Gather: one owner thread per output
element, or per 16 bytes of a row (4 f32 or 8 bf16 channels) where C
allows, any C (3 for xyz) and any M. Scatter: one launch and no glue (no
sort or ``searchsorted`` in torch). A block owns a tile of target rows of
one cloud (up to 32 channel groups of them); it streams the cloud's ids
through shared memory in chunks of 2048, in m order, and sorts the
chunk's ids that land in its tile by target with a stable counting sort
(``__match_any_sync`` ranks equal ids within a warp's round, a scan over
(target, warp) places them). The block asks L2 for the landed rows; owner
threads, one per (target row, 4 channels), add their rows of each chunk
in that order with eight row loads in flight, keep the sums in registers
across chunks and write once, zero rows included. So the scatter adds
what its plain version adds, in m order, in f32: bit-equal to it and the
same bits on every run. No float atomics: the ball query's repeat-fill
makes duplicate ids the normal case, and atomics would change the sum
from run to run. A target's rows form one chain of dependent adds; the
call with the most rows on one target (326) is the slowest of a train
step's three.

Bounds on the card, both by bytes: the gather reads the ids and the rows
they name and writes the output; the scatter reads the ids and the
values of the rows that land and writes the table (each tile re-reads
its cloud's ids, from L2, which the bound does not count: it is a
property of the design, not of the work).

On CPU tensors the wrappers compute their plain versions
(``gather_rows_reference``, ``scatter_rows_reference``); on CUDA tensors
they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from lisec_tpu_torch.ops.cuda import build

# Launches of each CUDA kernel since import.
GATHER_LAUNCHES = 0
SCATTER_LAUNCHES = 0

GATHER_INFO = {
    "name": "gather_rows",
    "route": "cuda",
    "source": "lisec_tpu_torch/csrc/gather_rows.cu",
    "replaces": "lisec_tpu/ops/pallas/gather_mxu.py:63",
}
SCATTER_INFO = {
    "name": "scatter_rows",
    "route": "cuda",
    "source": "lisec_tpu_torch/csrc/gather_rows.cu",
    "replaces": "lisec_tpu/ops/pallas/gather_mxu.py:122",
}

_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def gather_rows_reference(src: torch.Tensor, idx: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version of the gather kernel: ``torch.gather`` with a
    zero mask."""
    n, c = src.shape[1:]
    ok = (idx >= 0) & (idx < n)
    rows = torch.where(ok, idx, 0).long()
    out = torch.gather(src, 1, rows[..., None].expand(-1, -1, c))
    return torch.where(ok[..., None], out, torch.zeros((), dtype=src.dtype,
                                                       device=src.device))


def sort_rows(idx: torch.Tensor, num_rows: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version's ordering: each cloud's ids sorted stably (so
    equal ids keep m ascending), the rows in that order (B, M) int32, and
    the range ``[offsets[b, n], offsets[b, n + 1])`` of the sorted rows
    whose id is n, (B, num_rows + 1) int32. Ids outside ``[0, num_rows)``
    fall outside every range."""
    ids, order = torch.sort(idx, dim=1, stable=True)
    bounds = torch.arange(num_rows + 1, dtype=idx.dtype,
                          device=idx.device).expand(idx.shape[0], -1)
    offsets = torch.searchsorted(ids, bounds.contiguous(), out_int32=True)
    return ids, order.to(torch.int32), offsets


def scatter_rows_reference(vals: torch.Tensor, idx: torch.Tensor, *,
                           num_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the scatter kernel, with its additions in
    its order: rank r of every id's rows (m ascending) is added in round
    r, one ``index_add_`` whose targets are distinct, so each output
    element takes ``acc + v`` once a round, as the kernel's owner thread
    does."""
    b, m, c = vals.shape
    dev = vals.device
    ids, order, offsets = sort_rows(idx, num_rows)
    landed = (ids >= 0) & (ids < num_rows)
    safe = torch.where(landed, ids, 0).long()
    rank = torch.arange(m, device=dev) - offsets.gather(1, safe).long()
    target = (safe + torch.arange(b, device=dev)[:, None] * num_rows)[landed]
    rows = torch.gather(vals, 1, order.long()[..., None].expand(-1, -1, c))
    rows, rank = rows[landed], rank[landed]
    out = torch.zeros((b * num_rows, c), dtype=torch.float32, device=dev)
    for r in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = rank == r
        out.index_add_(0, target[sel], rows[sel])
    return out.view(b, num_rows, c)


def _library() -> ctypes.CDLL:
    lib = build.load("gather_rows")
    if lib.lisec_gather_rows.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lisec_gather_rows.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.lisec_gather_rows.restype = ctypes.c_int
        lib.lisec_scatter_rows.argtypes = [p, p, p, i, i, i, i, p]
        lib.lisec_scatter_rows.restype = ctypes.c_int
    return lib


def _check(table, idx, what, dtypes):
    if table.dtype not in dtypes or table.dim() != 3:
        raise ValueError(f"{what} must be (B, rows, C) in {dtypes}, got "
                         f"{tuple(table.shape)} {table.dtype}")
    b, rows, c = table.shape
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[0] != b:
        raise ValueError(f"idx must be ({b}, M) int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if idx.get_device() != table.get_device() or idx.is_cuda != table.is_cuda:
        raise ValueError(f"idx is on {idx.device}, {what} on {table.device}")
    if min(b, rows, c, idx.shape[1]) < 1:
        raise ValueError(f"need every size >= 1, got {tuple(table.shape)} "
                         f"and {tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{what} and idx must be contiguous")
    if not (table.is_cuda or table.is_cpu):
        raise ValueError(f"unsupported device {table.device}")


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, M, C) rows ``src[b, idx[b, m]]`` in src's type, zero rows for
    ids outside ``[0, N)``. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel."""
    global GATHER_LAUNCHES
    _check(src, idx, "src", tuple(_ELEM_BYTES))
    if not src.is_cuda:
        return gather_rows_reference(src, idx)
    b, n, c = src.shape
    m = idx.shape[1]
    if b * m * c >= 2 ** 31 * 256:
        raise ValueError("the kernel's grid cannot cover this output")
    out = torch.empty((b, m, c), dtype=src.dtype, device=src.device)
    err = _library().lisec_gather_rows(
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, m, c,
        _ELEM_BYTES[src.dtype], build.stream_of(src))
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: "
                           f"cudaError {err}")
    GATHER_LAUNCHES += 1
    return out


def scatter_rows(vals: torch.Tensor, idx: torch.Tensor, *,
                 num_rows: int) -> torch.Tensor:
    """(B, num_rows, C) f32 sums of the rows of vals (B, M, C) f32 onto
    their ids, in m order; ids outside ``[0, num_rows)`` dropped. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    global SCATTER_LAUNCHES
    _check(vals, idx, "vals", (torch.float32,))
    if idx.shape[1] != vals.shape[1]:
        raise ValueError(f"idx must have one id per row of vals, got "
                         f"{tuple(idx.shape)} and {tuple(vals.shape)}")
    if num_rows < 1:
        raise ValueError(f"num_rows must be >= 1, got {num_rows}")
    if not vals.is_cuda:
        return scatter_rows_reference(vals, idx, num_rows=num_rows)
    b, m, c = vals.shape
    if b * num_rows * c >= 2 ** 31 * 256:
        raise ValueError("the kernel's grid cannot cover this output")
    out = vals.new_empty((b, num_rows, c))
    err = _library().lisec_scatter_rows(
        vals.data_ptr(), idx.data_ptr(), out.data_ptr(), b, m, num_rows, c,
        build.stream_of(vals))
    if err != 0:
        raise RuntimeError(f"scatter_rows kernel launch failed: "
                           f"cudaError {err}")
    SCATTER_LAUNCHES += 1
    return out


class GatherRows(torch.autograd.Function):
    """Differentiable :func:`gather_rows`: (B, N, C) x (B, M) -> (B, M, C).
    The backward is :func:`scatter_rows` of the cotangent, cast to the
    source's type (the JAX package's ``_gather_bwd``), and runs only when
    the source needs a gradient."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.src_shape = src.shape
        ctx.src_dtype = src.dtype
        return gather_rows(src, idx)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        idx, = ctx.saved_tensors
        dsrc = scatter_rows(g.float().contiguous(), idx,
                            num_rows=ctx.src_shape[1])
        return dsrc.to(ctx.src_dtype), None
