"""Segment unpaint on Hopper: the row gather from a dense per-cell table,
and its two callers' work fused into it.

Replaces the TPU kernel ``lisec_tpu/ops/pallas/unpaint.py::
segment_unpaint`` (body ``_unpaint_kernel``). One source
(``csrc/segment_unpaint.cu``), three entries, one launch each:

* :func:`segment_unpaint`: ``out[b, i] = table[b, cell[b, i]]`` for
  ``table`` (B, R, C) f32 and ids ``cell`` (B, N) int32, zeros where the
  id is no row; (B, N, C) in f32 or bf16 (rounded to nearest even, as
  ``Tensor.to`` does). It copies bits, so it is exact (the TPU kernel's
  default mode returns a two-term bf16 reconstruction; this one never
  does). SECOND's sparse-conv backward gathers its cotangent rows with it,
  and the densify backward writes the features' type directly.
* :func:`segment_max_backward`: the segment max's VJP. Each row's id is
  read once; the kernel reads the row's canvas row, cotangent row and
  ``h``, compares ``h`` with the canvas exactly in f32 and writes ``dh``
  in ``h``'s type: the cotangent where they are equal (ties take it
  whole), else 0; 0 rows for invalid ids. The JAX backward routes both
  tables through one unpaint too, but compares the leading 17 mantissa
  bits; this one keeps exact f32 equality.
* :func:`pillar_decorate`: the pillar encoder's per-point decoration on
  the train path: the cell's xyz sums and count gathered, the mean, the
  cell centre, ``[x, y, z, r, xyz - mean, xy - centre] * valid`` written
  as (B, N, 9) f32. Every operation rounds as the plain version's
  separate torch ops do (no fused multiply-add).

The TPU kernel writes aligned windows that overrun into the neighbouring
ranges and patches the range starts afterwards. CUDA blocks run in no
order, so here every output element is written once by one lane, the
zero rows of invalid ids included; outputs come from ``new_empty``.
Design (``csrc/segment_unpaint.cu``): a row is moved by a group of lanes
sized to it (one thread for C = 4; 16-byte units where C and the pointers
allow), the group's first lane loads the id once and shuffles it to the
others, a group keeps two rows in flight, a block's rows are one cloud's
(no division), each lane computes a row's 64-bit bases once, and the
output is stored streaming (evict-first: it is written once and is far
larger than L2, where the ids and the table rows should stay). The
decoration is one thread a point, two points in flight, its 9-float rows
staged in shared memory and written as one coalesced run.

Bounds on the card, all by bytes (no entry does arithmetic that
matters against 67 TFLOP/s), computed by ``chip_smoke.py`` from the ids
of the run it times:

* gather: the ids, the distinct table rows they name, the output written
  once: ``4 B N + 4 C rows + B N C e`` bytes (e = 4 or 2);
* backward: the ids, the distinct canvas and cotangent rows, ``h`` read
  and ``dh`` written: ``4 B N + 8 C rows + 2 B N C e`` (a PointPillars
  train step, (4, 32768, 64) bf16 over 214,272 cells: about 45 MB);
* decoration: the ids, the points, the distinct stats rows, the 9-float
  rows written: ``4 B N + 16 B N + 16 rows + 36 B N`` (about 7.7 MB at
  (4, 32768)).

On a CPU tensor each entry computes its plain version
(``segment_unpaint_reference``, ``segment_max_backward_reference``,
``pillar_decorate_reference``); on a CUDA tensor it launches the kernel
or raises. The ``ctypes`` functions are bound once, the checks are one
expression each (the reason is worked out only for a refusal).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from lisec_tpu_torch.ops.cuda import build

# Launches of the source's kernels since import (all three entries).
LAUNCHES = 0

KERNEL_INFO = {
    "name": "segment_unpaint",
    "route": "cuda",
    "source": "lisec_tpu_torch/csrc/segment_unpaint.cu",
    "replaces": "lisec_tpu/ops/pallas/unpaint.py:131",
}

_F32, _BF16, _INT32 = torch.float32, torch.bfloat16, torch.int32
_IS_BF16 = {_F32: 0, _BF16: 1}
_MOST = 2 ** 31 - 1                 # each size is an int inside


def segment_unpaint_reference(table: torch.Tensor, cell_sorted: torch.Tensor,
                              out_dtype: torch.dtype = _F32
                              ) -> torch.Tensor:
    """Plain PyTorch version of the gather: ``torch.gather`` with a zero
    mask, then the cast."""
    r, c = table.shape[1:]
    ok = (cell_sorted >= 0) & (cell_sorted < r)
    idx = torch.where(ok, cell_sorted, 0).long()
    out = torch.gather(table, 1, idx[..., None].expand(-1, -1, c))
    return torch.where(ok[..., None], out, 0.0).to(out_dtype)


def segment_max_backward_reference(h: torch.Tensor, cell_sorted: torch.Tensor,
                                   canvas: torch.Tensor,
                                   g_canvas: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the segment-max backward: the two
    gathers, the exact f32 compare, ``where`` and the cast."""
    mx = segment_unpaint_reference(canvas, cell_sorted)
    gp = segment_unpaint_reference(g_canvas, cell_sorted)
    return torch.where(h.float() == mx, gp, 0.0).to(h.dtype)


def pillar_decorate_reference(pts_s: torch.Tensor, cell_s: torch.Tensor,
                              stats: torch.Tensor, *,
                              grid: Tuple[int, int],
                              voxel_size: Sequence[float],
                              pc_range: Sequence[float]) -> torch.Tensor:
    """Plain PyTorch version of the decoration: the stats rows gathered,
    then the encoder's torch ops one by one."""
    nx, ny = grid
    ncells = nx * ny
    r = pc_range
    ones = (cell_s < ncells).float()[..., None]
    xyz = pts_s[..., :3]
    per_pt = segment_unpaint_reference(stats, cell_s)          # (B, N, 4)
    mean_pt = per_pt[..., :3] / per_pt[..., 3:].clamp_min(1.0)

    cell_c = cell_s.clamp(max=ncells - 1)
    px = ((cell_c % nx).float() + 0.5) * voxel_size[0] + r[0]
    py = ((cell_c // nx).float() + 0.5) * voxel_size[1] + r[1]
    center = torch.stack([pts_s[..., 0] - px, pts_s[..., 1] - py], -1)
    return torch.cat([pts_s, xyz - mean_pt, center], -1) * ones


_unpaint_fn = _backward_fn = _decorate_fn = None


def _bind() -> None:
    """Bind the library's three entry points once (every pointer and size
    one 64-bit word; the decoration's geometry as C floats)."""
    global _unpaint_fn, _backward_fn, _decorate_fn
    w, f = ctypes.c_void_p, ctypes.c_float
    _unpaint_fn = build.bind("segment_unpaint", "lisec_segment_unpaint",
                             [w] * 9)
    _backward_fn = build.bind("segment_unpaint",
                              "lisec_segment_max_backward", [w] * 11)
    _decorate_fn = build.bind("segment_unpaint", "lisec_pillar_decorate",
                              [w] * 8 + [f] * 4 + [w])


def _launched(err: int, what: str) -> None:
    global LAUNCHES
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
    LAUNCHES += 1


def _refuse(tensors, ids):
    """Raise the ValueError that says why a check refused: ``tensors`` is
    ((name, tensor, dtypes, shape), ...) with None in a shape for any
    size; ``ids`` the (B, N) int32 ids."""
    b = ids.shape[0] if ids.dim() == 2 else -1
    if ids.dtype != _INT32 or ids.dim() != 2:
        raise ValueError(f"the ids must be (B, N) int32, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    for name, t, dtypes, shape in tensors:
        shape = tuple(b if s == "B" else s for s in shape)
        if (t.dtype not in dtypes or t.dim() != len(shape)
                or any(s is not None and got != s
                       for got, s in zip(t.shape, shape))):
            raise ValueError(f"{name} must be {shape} (None: any) in "
                             f"{dtypes}, got {tuple(t.shape)} {t.dtype}")
    for name, t, _, _ in tensors:
        if t.get_device() != ids.get_device():
            raise ValueError(f"{name} is on {t.device}, the ids on "
                             f"{ids.device}")
    for name, t, _, _ in tensors + (("ids", ids, None, None),):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    sizes = [tuple(t.shape) for _, t, _, _ in tensors]
    raise ValueError(f"need every size >= 1, got {sizes} and ids "
                     f"{tuple(ids.shape)}")


def _too_large(*sizes) -> None:
    """The kernels index with ints: refuse a size of 2^31 or more."""
    if max(sizes) > _MOST:
        raise ValueError(f"every size must be below 2^31, got {sizes}")


def segment_unpaint(table: torch.Tensor, cell_sorted: torch.Tensor,
                    out_dtype: torch.dtype = _F32) -> torch.Tensor:
    """Per-row table rows (B, N, C) in ``out_dtype`` (f32 or bf16):
    ``out[b, i] = table[b, cell[b, i]]``, zeros where the id is negative
    or >= R. Ids need not be sorted (sorted ids make the reads local). A
    CPU tensor takes the plain version; a CUDA tensor launches the
    kernel."""
    ts, cs = table.shape, cell_sorted.shape
    if not (len(ts) == 3 and len(cs) == 2 and ts[0] == cs[0]
            and table.dtype is _F32 and cell_sorted.dtype is _INT32
            and out_dtype in _IS_BF16 and table.numel()
            and cell_sorted.numel() and table.is_contiguous()
            and cell_sorted.is_contiguous()
            and table.get_device() == cell_sorted.get_device()):
        if out_dtype not in _IS_BF16:
            raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                             f"{out_dtype}")
        _refuse((("table", table, (_F32,), ("B", None, None)),), cell_sorted)
    if not table.is_cuda:
        return segment_unpaint_reference(table, cell_sorted, out_dtype)
    b, r, c = ts
    n = cs[1]
    _too_large(b, r, c, n)
    if _unpaint_fn is None:
        _bind()
    out = table.new_empty((b, n, c), dtype=out_dtype)
    _launched(_unpaint_fn(table.data_ptr(), cell_sorted.data_ptr(),
                          out.data_ptr(), b, n, r, c, _IS_BF16[out_dtype],
                          build.stream_of(table)), "segment_unpaint")
    return out


def segment_max_backward(h: torch.Tensor, cell_sorted: torch.Tensor,
                         canvas: torch.Tensor, g_canvas: torch.Tensor
                         ) -> torch.Tensor:
    """The segment max's gradient ``dh`` (B, N, C) in h's type (f32 or
    bf16): the cotangent row ``g_canvas[b, cell]`` where ``h`` equals the
    canvas row ``canvas[b, cell]`` exactly (as f32), else 0; zero rows for
    ids outside ``[0, R)``. canvas and g_canvas (B, R, C) f32. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    hs, cs, ks = h.shape, cell_sorted.shape, canvas.shape
    dev = cell_sorted.get_device()
    if not (len(hs) == 3 and len(cs) == 2 and len(ks) == 3
            and hs[0] == cs[0] == ks[0] and hs[1] == cs[1]
            and ks[2] == hs[2] and g_canvas.shape == ks
            and h.dtype in _IS_BF16 and canvas.dtype is _F32
            and g_canvas.dtype is _F32 and cell_sorted.dtype is _INT32
            and h.numel() and canvas.numel() and h.is_contiguous()
            and canvas.is_contiguous() and g_canvas.is_contiguous()
            and cell_sorted.is_contiguous() and h.get_device() == dev
            and canvas.get_device() == dev
            and g_canvas.get_device() == dev):
        n = cs[1] if len(cs) == 2 else None
        c = hs[2] if len(hs) == 3 else None
        r = ks[1] if len(ks) == 3 else None
        _refuse((("h", h, tuple(_IS_BF16), ("B", n, None)),
                 ("canvas", canvas, (_F32,), ("B", None, c)),
                 ("g_canvas", g_canvas, (_F32,), ("B", r, c))), cell_sorted)
    if not h.is_cuda:
        return segment_max_backward_reference(h, cell_sorted, canvas,
                                              g_canvas)
    b, n, c = hs
    _too_large(b, n, c, ks[1])
    if _backward_fn is None:
        _bind()
    dh = h.new_empty(hs)
    _launched(_backward_fn(h.data_ptr(), cell_sorted.data_ptr(),
                           canvas.data_ptr(), g_canvas.data_ptr(),
                           dh.data_ptr(), b, n, ks[1], c, _IS_BF16[h.dtype],
                           build.stream_of(h)), "segment_max_backward")
    return dh


def pillar_decorate(pts_s: torch.Tensor, cell_s: torch.Tensor,
                    stats: torch.Tensor, *, grid: Tuple[int, int],
                    voxel_size: Sequence[float],
                    pc_range: Sequence[float]) -> torch.Tensor:
    """The decorated points (B, N, 9) f32 ``[x, y, z, r, xyz - cell mean,
    xy - cell centre] * (cell < nx * ny)`` of points ``pts_s`` (B, N, 4)
    f32 sorted by cell ``cell_s`` (B, N) int32, from the per-cell xyz sums
    and count ``stats`` (B, nx * ny, 4) f32. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    nx, ny = grid
    ps, cs, ss = pts_s.shape, cell_s.shape, stats.shape
    dev = cell_s.get_device()
    if not (len(ps) == 3 and len(cs) == 2 and len(ss) == 3
            and ps[0] == cs[0] == ss[0] and ps[1] == cs[1] and ps[2] == 4
            and ss[1] == nx * ny and ss[2] == 4 and pts_s.dtype is _F32
            and stats.dtype is _F32 and cell_s.dtype is _INT32
            and pts_s.numel() and stats.numel() and pts_s.is_contiguous()
            and stats.is_contiguous() and cell_s.is_contiguous()
            and pts_s.get_device() == dev and stats.get_device() == dev):
        n = cs[1] if len(cs) == 2 else None
        _refuse((("pts_s", pts_s, (_F32,), ("B", n, 4)),
                 ("stats", stats, (_F32,), ("B", nx * ny, 4))), cell_s)
    if not pts_s.is_cuda:
        return pillar_decorate_reference(pts_s, cell_s, stats, grid=grid,
                                         voxel_size=voxel_size,
                                         pc_range=pc_range)
    b, n = cs
    _too_large(b, n, ss[1])
    if _decorate_fn is None:
        _bind()
    feats = pts_s.new_empty((b, n, 9))
    _launched(_decorate_fn(pts_s.data_ptr(), cell_s.data_ptr(),
                           stats.data_ptr(), feats.data_ptr(), b, n,
                           nx * ny, nx, float(voxel_size[0]),
                           float(voxel_size[1]), float(pc_range[0]),
                           float(pc_range[1]), build.stream_of(pts_s)),
              "pillar_decorate")
    return feats
