"""Fused pillar encoder on Hopper: raw padded points -> BEV canvas.

Replaces the TPU kernel ``lisec_tpu/ops/pallas/encoder_kernel.py::
pillar_canvas_fused`` (body ``_encoder_kernel``). It computes, for every
cell of the (nx, ny) grid,

    canvas = relu(max_p u_p - mean @ w[4:7] - center @ w[7:9] + t)

with u_p = [x, y, z, r] @ weff the per-point term of the BN-folded PFN
(weff folds the absolute-decoration columns, see the CUDA source), mean
the cell's xyz mean and center its geometric centre; empty cells are 0.

Bound on the card: the function must read the points (16 B) and the
mask (1 B) of every point and write the canvas once, B * ncells * C *
bytes(out). At KITTI size (214,272 cells, C = 64, bf16, 32,768 points)
that is 27.43 MB of canvas + 0.56 MB of points, about 28.0 MB per cloud,
or about 8.4 us per cloud at 3.35 TB/s; its arithmetic (8 C flops per
point) is negligible. It is bound by the canvas write.

Design (``csrc/encoder_kernel.cu``), two launches and no torch op
around them but the allocation of the canvas and of one int32 scratch:
a first kernel computes every point's cell id with ``pillar_cells``'
f32 arithmetic and counts, per chunk of 1,024 points, the points that
land in each tile of 2,048 cells; a second kernel gives each (cloud,
tile) a block that streams the ids of the chunks holding any of its
points (from L2), puts the keys (cell, point index) of those that land
in order in shared memory (each into its cell's bucket, then to the
place its rank in the bucket gives it), writes the tile's empty rows as
zeros with 16-byte stores, and walks each non-empty cell with one warp
over its points in point order (running max of u and f64 xyz sums in
registers, the epilogue, one coalesced row). A tile with more points
than the 4,096 keys its shared memory holds is taken in runs of cells
that fit, and a cell with more than that alone is walked by one warp
straight from the ids. No atomics reach the canvas: every element is
written once, in an order the keys fix, so a run repeats bit for bit.
The glue this replaces (``sort_by_cell``: a stable ``torch.sort``, a
gather, an ``arange`` and a ``searchsorted``) stays for the plain
version and the train path.

On a CPU tensor ``pillar_canvas_fused`` computes the plain version
``pillar_canvas_fused_reference``; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from lisec_tpu_torch.ops.cuda import build

# Launches of the CUDA kernel since import (the main path's proof that it
# went through the kernel).
LAUNCHES = 0

# What the kernel is and what it replaces, for reports.
KERNEL_INFO = {
    "name": "pillar_canvas_fused",
    "route": "cuda",
    "source": "lisec_tpu_torch/csrc/encoder_kernel.cu",
    "replaces": "lisec_tpu/ops/pallas/encoder_kernel.py:277",
}

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def pillar_cells(points: torch.Tensor, point_mask: torch.Tensor, *,
                 grid: Tuple[int, int], voxel_size: Sequence[float],
                 pc_range: Sequence[float]):
    """Cell id of every point, ``nx * ny`` where it is masked or out of
    range. Returns (cell (B, N) int32, valid (B, N) bool, ix, iy).

    Same f32 arithmetic as the JAX encoder's ``_cells`` as it runs in the
    JAX package's jitted programs: XLA rewrites the division by the
    constant voxel size into a multiply by its f32 reciprocal, so this
    multiplies too. (A true division puts about a tenth of the points
    that lie exactly on cell edges into the other cell.)"""
    nx, ny = grid
    r = pc_range
    inv = [float(np.float32(1.0) / np.float32(v)) for v in voxel_size[:2]]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    # Clamp before the int cast so far-away points cannot overflow it;
    # the clamp keeps them out of range.
    fx = torch.floor((x - r[0]) * inv[0]).clamp(-1, nx)
    fy = torch.floor((y - r[1]) * inv[1]).clamp(-1, ny)
    ix, iy = fx.to(torch.int32), fy.to(torch.int32)
    valid = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
             & (z >= r[2]) & (z < r[5]) & point_mask.to(torch.bool))
    cell = torch.where(valid, iy * nx + ix, torch.full_like(ix, nx * ny))
    return cell, valid, ix, iy


def sort_by_cell(points, point_mask, *, grid, voxel_size, pc_range):
    """Co-sort the points by cell id and find every cell's point range
    (the plain version's and the train path's glue; the kernels order the
    points in shared memory instead).

    Returns (cell_s (B, N) int32, pts_s (B, N, 4) f32, offsets
    (B, ncells + 1) int32): the points of cell c of cloud b are
    ``pts_s[b, offsets[b, c]:offsets[b, c + 1]]``."""
    nx, ny = grid
    ncells = nx * ny
    b = points.shape[0]
    cell, _, _, _ = pillar_cells(points, point_mask, grid=grid,
                                 voxel_size=voxel_size, pc_range=pc_range)
    cell_s, order = torch.sort(cell, dim=1, stable=True)
    pts_s = torch.gather(points, 1, order[..., None].expand(-1, -1, 4))
    bounds = torch.arange(ncells + 1, dtype=torch.int32,
                          device=points.device).expand(b, -1).contiguous()
    offsets = torch.searchsorted(cell_s, bounds, out_int32=True)
    return cell_s, pts_s.contiguous(), offsets


def _weff(w: torch.Tensor) -> torch.Tensor:
    """(4, C): weff for feats_abs = [x, y, z, r, x, y, z, x, y]."""
    return torch.stack([(w[0] + w[4]) + w[7], (w[1] + w[5]) + w[8],
                        w[2] + w[6], w[3]])


def cell_centers(ncells: int, nx: int, voxel_size, pc_range, device):
    """(ncells,) x and y of every cell's centre, in f32."""
    idx = torch.arange(ncells, device=device)
    cx = ((idx % nx).to(torch.float32) + 0.5) * voxel_size[0] + pc_range[0]
    cy = ((idx // nx).to(torch.float32) + 0.5) * voxel_size[1] + pc_range[1]
    return cx, cy


def pillar_canvas_fused_reference(
    points: torch.Tensor, point_mask: torch.Tensor, w: torch.Tensor,
    t: torch.Tensor, *, grid: Tuple[int, int], voxel_size: Sequence[float],
    pc_range: Sequence[float], out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same glue, then a scatter max
    and index_add sums): (B, N, 4) points -> (B, ny * nx, C) canvas.

    It performs the kernel's f32 operations in the kernel's order (u and
    the epilogue elementwise, not as matmuls; the xyz sums in f64), so
    the two agree to the order of the f64 sums."""
    nx, ny = grid
    ncells = nx * ny
    b = points.shape[0]
    c = w.shape[1]
    cell_s, pts_s, _ = sort_by_cell(points, point_mask, grid=grid,
                                    voxel_size=voxel_size,
                                    pc_range=pc_range)
    x, y, z, r = (pts_s[..., i:i + 1] for i in range(4))
    we = _weff(w)
    u = ((x * we[0] + y * we[1]) + z * we[2]) + r * we[3]      # (B, N, C)

    # One trash row per cloud (id ncells) collects invalid points.
    rows = (cell_s.long() + torch.arange(b, device=points.device)[:, None]
            * (ncells + 1)).reshape(-1)
    umax = torch.full((b * (ncells + 1), c), float("-inf"),
                      device=points.device).scatter_reduce_(
        0, rows[:, None].expand(-1, c), u.reshape(-1, c), "amax",
        include_self=False)
    stats = torch.cat([pts_s[..., :3], torch.ones_like(x)], -1)
    sums = torch.zeros((b * (ncells + 1), 4), dtype=torch.float64,
                       device=points.device).index_add_(
        0, rows, stats.reshape(-1, 4).double())
    umax = umax.view(b, ncells + 1, c)[:, :ncells]
    sums = sums.view(b, ncells + 1, 4)[:, :ncells].float()

    count = sums[..., 3:4]
    mean = sums[..., :3] / count.clamp_min(1.0)
    b_mean = ((mean[..., 0:1] * w[4] + mean[..., 1:2] * w[5])
              + mean[..., 2:3] * w[6])
    cx, cy = cell_centers(ncells, nx, voxel_size, pc_range, points.device)
    b_ctr = cx[:, None] * w[7] + cy[:, None] * w[8]            # (cells, C)
    v = ((umax - b_mean) - b_ctr) + t
    canvas = torch.where(count > 0, v.clamp_min(0.0), 0.0)
    return canvas.to(out_dtype)


_canvas_fn = None

# Mirrors of the CUDA source's constants: points a chunk and cells a tile
# (which size the int32 scratch of ids and per-chunk tile counts), the
# keys a tile orders in shared memory at once, the points a cloud (a
# key's index bits) and the cells a cloud.
CHUNK_POINTS = 1024
TILE_CELLS = 2048
KEYS_PER_PASS = 4096
MAX_POINTS = 1 << 20
MAX_CELLS = 4096 * TILE_CELLS


@functools.lru_cache(maxsize=None)
def _reciprocals(voxel_size: Tuple[float, float]) -> Tuple[float, float]:
    """The f32 reciprocals ``pillar_cells`` multiplies by."""
    return tuple(float(np.float32(1.0) / np.float32(v))
                 for v in voxel_size)


def _launch(points, point_mask, w, t, out, *, grid, voxel_size,
            pc_range) -> None:
    """Launch the two kernels on checked CUDA tensors."""
    global LAUNCHES, _canvas_fn
    b, n, _ = points.shape
    nx, ny = grid
    # (B, N rounded up to 4) ids, then (B, nchunks, ntiles) counts.
    words = b * (-(-n // 4) * 4 + -(-n // CHUNK_POINTS)
                 * -(-(nx * ny) // TILE_CELLS))
    scratch = points.new_empty((words,), dtype=torch.int32)
    if _canvas_fn is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _canvas_fn = build.bind(
            "encoder_kernel", "lisec_pillar_canvas_fused",
            [p, p, p, p, p, p, i, i, i, i, i, f, f, f, f, f, f, f, f, i, p])
    inv0, inv1 = _reciprocals(tuple(voxel_size[:2]))
    r = pc_range
    err = _canvas_fn(
        points.data_ptr(), point_mask.data_ptr(), w.data_ptr(),
        t.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, n, w.shape[1],
        nx, ny, voxel_size[0], voxel_size[1], r[0], r[1], r[2], r[5], inv0,
        inv1, int(out.dtype == torch.bfloat16), build.stream_of(points))
    if err != 0:
        raise RuntimeError(
            f"pillar_canvas_fused kernel launch failed: cudaError {err}")
    LAUNCHES += 1


def _check(points, point_mask, w, t, out_dtype):
    dev = points.device
    if points.dtype != torch.float32 or points.dim() != 3 \
            or points.shape[-1] != 4:
        raise ValueError(f"points must be (B, N, 4) float32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    if point_mask.shape != points.shape[:2] \
            or point_mask.dtype != torch.bool:
        raise ValueError(f"point_mask must be {tuple(points.shape[:2])} "
                         f"bool, got {tuple(point_mask.shape)} "
                         f"{point_mask.dtype}")
    if points.data_ptr() % 16:
        raise ValueError("points must be 16-byte aligned (a float4 a point)")
    if points.shape[1] > MAX_POINTS:
        raise ValueError(f"the kernel takes at most {MAX_POINTS} points "
                         "a cloud")
    c = w.shape[-1]
    if w.dtype != torch.float32 or w.shape != (9, c) or t.shape != (c,) \
            or t.dtype != torch.float32:
        raise ValueError("w must be (9, C) and t (C,), both float32")
    if c % 32 or not 32 <= c <= 256:
        raise ValueError(f"the kernel takes C a multiple of 32 in "
                         f"[32, 256], got {c}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_DTYPES}")
    if not 1 <= points.shape[0] <= 65535:
        raise ValueError("the kernel takes 1 to 65535 clouds")
    for name, a in (("point_mask", point_mask), ("w", w), ("t", t)):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, points on {dev}")
    for name, a in (("points", points), ("point_mask", point_mask),
                    ("w", w), ("t", t)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def pillar_canvas_fused(
    points: torch.Tensor, point_mask: torch.Tensor, w: torch.Tensor,
    t: torch.Tensor, *, grid: Tuple[int, int], voxel_size: Sequence[float],
    pc_range: Sequence[float], out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Fused pillar encoder: returns the (B, ny * nx, C) canvas.

    points (B, N, 4) f32 x, y, z, reflectance, 16-byte aligned;
    point_mask (B, N) bool; w (9, C) and t (C,) the BN-folded PFN weights
    and bias. A CPU tensor takes the plain version; a CUDA tensor launches
    the two kernels (one call in ``LAUNCHES``)."""
    _check(points, point_mask, w, t, out_dtype)
    kw = dict(grid=grid, voxel_size=voxel_size, pc_range=pc_range)
    if points.device.type == "cpu":
        return pillar_canvas_fused_reference(points, point_mask, w, t,
                                             out_dtype=out_dtype, **kw)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    nx, ny = grid
    if nx * ny > MAX_CELLS:
        raise ValueError(f"the kernel takes at most {MAX_CELLS} cells")
    out = points.new_empty((points.shape[0], nx * ny, w.shape[1]),
                           dtype=out_dtype)
    _launch(points, point_mask, w, t, out, **kw)
    return out
