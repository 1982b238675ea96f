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

Design (``csrc/gather_rows.cu``). Gather: a row is moved by a group of
lanes (one thread for a row of at most four units, such as xyz's 12
bytes; else up to 32 lanes, 16 bytes a lane where C allows); the group's
first lane loads the id once and shares the source row by a shuffle;
a lane group keeps two rows in flight; offsets are 32-bit. Grouping
(``group_and_decorate``): the same gather of xyz and, optionally,
features with the same ids, the centre subtracted from the coordinates,
written in one launch straight into the (B, M, K, 3 + C) tensor the
shared MLP reads. Scatter: one launch and no glue (no
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

Bounds on the card, all by bytes: the gather reads the ids and the rows
they name and writes the output; the grouping reads those and the
centres; the scatter reads the ids and the
values of the rows that land and writes the table (each tile re-reads
its cloud's ids, from L2, which the bound does not count: it is a
property of the design, not of the work).

On CPU tensors the wrappers compute their plain versions
(``gather_rows_reference``, ``group_and_decorate_reference``,
``scatter_rows_reference``); on CUDA tensors they launch the kernels or
raise. The wrappers' host work is what ``torch.gather`` pays: the
``ctypes`` functions are bound once, the checks are one expression (the
reason is worked out only for a refusal), the output comes from
``new_empty`` and the stream from ``build.stream_of``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from lisec_tpu_torch.ops.cuda import build

# Launches of each CUDA kernel since import; the grouping's launches count
# as the gather's (one source, one kernel family).
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
# The kernels' offsets are 32-bit: every tensor they index stays below.
_MAX_ELEMS = 2 ** 31
_INT32 = torch.int32
_F32 = (torch.float32,)


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


def group_and_decorate_reference(xyz: torch.Tensor,
                                 features: Optional[torch.Tensor],
                                 centers: torch.Tensor, idx: torch.Tensor
                                 ) -> torch.Tensor:
    """Plain PyTorch version of the grouping kernel: the gathers of xyz
    and features with the same ids, the centre subtracted from the
    coordinates, the two concatenated. xyz (B, N, 3), features (B, N, C)
    or None, centers (B, M, 3), idx (B, M, K) -> (B, M, K, 3 + C)."""
    b, m, k = idx.shape
    flat = idx.reshape(b, m * k)
    grouped = (gather_rows_reference(xyz, flat).view(b, m, k, 3)
               - centers[:, :, None])
    if features is None:
        return grouped
    return torch.cat([grouped, gather_rows_reference(features, flat).view(
        b, m, k, features.shape[2])], dim=-1)


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


_gather_fn = _group_fn = _scatter_fn = None


def _bind() -> None:
    """Bind the library's three entry points once (every argument one
    64-bit word)."""
    global _gather_fn, _group_fn, _scatter_fn
    words = [ctypes.c_void_p]
    _gather_fn = build.bind("gather_rows", "lisec_gather_rows", words * 9)
    _group_fn = build.bind("gather_rows", "lisec_group_rows", words * 11)
    _scatter_fn = build.bind("gather_rows", "lisec_scatter_rows", words * 8)


def _refuse(table, idx, what, dtypes):
    """Raise the ValueError that says why ``_check`` refused."""
    if table.dtype not in dtypes or table.dim() != 3:
        raise ValueError(f"{what} must be (B, rows, C) in {dtypes}, got "
                         f"{tuple(table.shape)} {table.dtype}")
    b, rows, c = table.shape
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[0] != b:
        raise ValueError(f"idx must be ({b}, M) int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if idx.get_device() != table.get_device():
        raise ValueError(f"idx is on {idx.device}, {what} on {table.device}")
    if min(b, rows, c, idx.shape[1]) < 1:
        raise ValueError(f"need every size >= 1, got {tuple(table.shape)} "
                         f"and {tuple(idx.shape)}")
    raise ValueError(f"{what} and idx must be contiguous")


def _check(table, idx, what, dtypes):
    """Refuse what the kernels cannot take; returns (table's shape, M)."""
    shape, ishape = table.shape, idx.shape
    if not (len(shape) == 3 and len(ishape) == 2 and shape[0] == ishape[0]
            and table.dtype in dtypes and idx.dtype == _INT32
            and table.numel() and idx.numel() and table.is_contiguous()
            and idx.is_contiguous()
            and idx.get_device() == table.get_device()):
        _refuse(table, idx, what, dtypes)
    return shape, ishape[1]


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, M, C) rows ``src[b, idx[b, m]]`` in src's type, zero rows for
    ids outside ``[0, N)``. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel."""
    global GATHER_LAUNCHES
    (b, n, c), m = _check(src, idx, "src", _ELEM_BYTES)
    if not src.is_cuda:
        return gather_rows_reference(src, idx)
    if b * n * c >= _MAX_ELEMS or b * m * c >= _MAX_ELEMS:
        raise ValueError("the kernel's 32-bit offsets cannot cover this "
                         "gather")
    if _gather_fn is None:
        _bind()
    out = src.new_empty(b, m, c)
    err = _gather_fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n,
                     m, c, _ELEM_BYTES[src.dtype], build.stream_of(src))
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: "
                           f"cudaError {err}")
    GATHER_LAUNCHES += 1
    return out


def _refuse_group(xyz, features, centers, idx):
    """Raise the ValueError that says why ``_check_group`` refused."""
    b, n = xyz.shape[:2] if xyz.dim() == 3 else (-1, -1)
    parts = [("xyz", xyz, (b, None, 3)), ("centers", centers, (b, None, 3))]
    if features is not None:
        parts.append(("features", features, (b, n, None)))
    for name, t, shape in parts:
        if (t.dtype != torch.float32 or t.dim() != 3 or any(
                want is not None and got != want
                for got, want in zip(t.shape, shape))):
            raise ValueError(f"{name} must be float32 of shape {shape} "
                             f"(None: any), got {tuple(t.shape)} {t.dtype}")
    m = centers.shape[1]
    if (idx.dtype != torch.int32 or idx.dim() != 3
            or idx.shape[:2] != (b, m)):
        raise ValueError(f"idx must be ({b}, {m}, K) int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    for name, t, _ in parts + [("idx", idx, None)]:
        if t.get_device() != xyz.get_device():
            raise ValueError(f"{name} is on {t.device}, xyz on "
                             f"{xyz.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    shapes = [tuple(t.shape) for t in (xyz, features, idx) if t is not None]
    raise ValueError(f"need every size >= 1, got {shapes}")


def _check_group(xyz, features, centers, idx):
    """Refuse what the grouping kernel cannot take; returns (B, N, M, K,
    C)."""
    xs, cs, ins = xyz.shape, centers.shape, idx.shape
    dev = xyz.get_device()
    c = 0
    if features is not None:
        fs = features.shape
        if not (len(fs) == 3 and fs[:2] == xs[:2] and fs[2]
                and features.dtype == _F32[0] and features.is_contiguous()
                and features.get_device() == dev):
            _refuse_group(xyz, features, centers, idx)
        c = fs[2]
    if not (len(xs) == 3 and len(cs) == 3 and len(ins) == 3
            and xs[2] == 3 and cs[2] == 3 and cs[0] == xs[0]
            and ins[:2] == cs[:2] and xs[1] and ins[0] and ins[1] and ins[2]
            and xyz.dtype == _F32[0] and centers.dtype == _F32[0]
            and idx.dtype == _INT32 and xyz.is_contiguous()
            and centers.is_contiguous() and idx.is_contiguous()
            and centers.get_device() == dev and idx.get_device() == dev):
        _refuse_group(xyz, features, centers, idx)
    return xs[0], xs[1], ins[1], ins[2], c


def group_and_decorate(xyz: torch.Tensor, features: Optional[torch.Tensor],
                       centers: torch.Tensor, idx: torch.Tensor
                       ) -> torch.Tensor:
    """(B, M, K, 3 + C) f32: ``xyz[b, idx[b, m, k]] - centers[b, m]``,
    then ``features[b, idx[b, m, k]]`` (none when features is None);
    ids outside ``[0, N)`` read zero rows. xyz (B, N, 3), features
    (B, N, C), centers (B, M, 3), all f32; idx (B, M, K) int32. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    global GATHER_LAUNCHES
    b, n, m, k, c = _check_group(xyz, features, centers, idx)
    if not xyz.is_cuda:
        return group_and_decorate_reference(xyz, features, centers, idx)
    if b * n * max(c, 3) >= _MAX_ELEMS or b * m * k * (3 + c) >= _MAX_ELEMS:
        raise ValueError("the kernel's 32-bit offsets cannot cover this "
                         "grouping")
    if _group_fn is None:
        _bind()
    out = xyz.new_empty(b, m, k, 3 + c)
    err = _group_fn(xyz.data_ptr(), None if features is None
                    else features.data_ptr(), centers.data_ptr(),
                    idx.data_ptr(), out.data_ptr(), b, n, m * k, k, c,
                    build.stream_of(xyz))
    if err != 0:
        raise RuntimeError(f"group_and_decorate kernel launch failed: "
                           f"cudaError {err}")
    GATHER_LAUNCHES += 1
    return out


def scatter_rows(vals: torch.Tensor, idx: torch.Tensor, *,
                 num_rows: int) -> torch.Tensor:
    """(B, num_rows, C) f32 sums of the rows of vals (B, M, C) f32 onto
    their ids, in m order; ids outside ``[0, num_rows)`` dropped. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    global SCATTER_LAUNCHES
    (b, m, c), m_ids = _check(vals, idx, "vals", _F32)
    if m_ids != m:
        raise ValueError(f"idx must have one id per row of vals, got "
                         f"{tuple(idx.shape)} and {tuple(vals.shape)}")
    if num_rows < 1:
        raise ValueError(f"num_rows must be >= 1, got {num_rows}")
    if not vals.is_cuda:
        return scatter_rows_reference(vals, idx, num_rows=num_rows)
    if b * num_rows * c >= 2 ** 31 * 256:
        raise ValueError("the kernel's grid cannot cover this output")
    if _scatter_fn is None:
        _bind()
    out = vals.new_empty(b, num_rows, c)
    err = _scatter_fn(vals.data_ptr(), idx.data_ptr(), out.data_ptr(), b, m,
                      num_rows, c, build.stream_of(vals))
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


class GroupAndDecorate(torch.autograd.Function):
    """Differentiable :func:`group_and_decorate`. The backward gives the
    features' gradient by :func:`scatter_rows` of ``g[..., 3:]`` (what
    ``GatherRows`` gave the separate feature gather), and xyz's and the
    centres' only where they need one: the scatter of ``g[..., :3]`` and
    minus its sum over K."""

    @staticmethod
    def forward(ctx, xyz, features, centers, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = xyz.shape[1]
        return group_and_decorate(xyz, features, centers, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        b, m, k, w = g.shape
        flat = idx.view(b, m * k)
        need_xyz, need_feat, need_ctr, _ = ctx.needs_input_grad
        g = g.float()
        dxyz = dfeat = dctr = None
        if need_feat:
            dfeat = scatter_rows(
                g[..., 3:].reshape(b, m * k, w - 3).contiguous(), flat,
                num_rows=ctx.num_rows)
        if need_xyz:
            dxyz = scatter_rows(
                g[..., :3].reshape(b, m * k, 3).contiguous(), flat,
                num_rows=ctx.num_rows)
        if need_ctr:
            dctr = -g[..., :3].sum(dim=2)
        return dxyz, dfeat, dctr, None
