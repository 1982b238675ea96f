"""Sparse 3D convolution over padded voxel lists (port of
``lisec_tpu/ops/sparse_conv.py``).

Voxel coords arrive sorted by linearized cell id with the valid rows
first (the voxelizer and the output-set functions guarantee it), so every
lookup is a ``searchsorted`` over sorted ids. All shapes are static:
lists are padded to per-level budgets and a count says how many rows are
real. The integers these functions return (coords, counts, rulebooks)
equal the JAX package's exactly.

The convolution is evaluated scatter-form: one matrix product per kernel
offset, each product row routed to its output voxel and the offsets
added up. On the card ``spread_conv`` (``lisec_tpu_torch/ops/cuda/``)
does all of it in one kernel, reading the rulebook's inverse; on the CPU
its plain version runs the two steps, ``einsum`` and the spread. Its
gradient is written out as an ``autograd.Function`` whose row gather is
the unpaint kernel. The gather form (``build_rulebook``,
``sparse_conv3d``) is the plain oracle the tests hold it against.

Integer divisions floor and remainders take the divisor's sign, as in
the JAX package: taps below the grid's low edge give negative numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from lisec_tpu_torch.ops.cuda.segment_unpaint import segment_unpaint
from lisec_tpu_torch.ops.cuda.spread_conv import spread_conv
from lisec_tpu_torch.utils.profiling import span


class SparseConvSpec(NamedTuple):
    """Static geometry of one sparse conv layer."""

    kernel_size: Tuple[int, int, int]     # (kz, ky, kx)
    stride: Tuple[int, int, int]
    padding: Tuple[int, int, int]
    grid_in: Tuple[int, int, int]         # (nz, ny, nx)

    @property
    def grid_out(self) -> Tuple[int, int, int]:
        return tuple(
            (g + 2 * p - k) // s + 1
            for g, k, s, p in zip(
                self.grid_in, self.kernel_size, self.stride, self.padding))

    def offsets(self, device=None) -> torch.Tensor:
        """(K, 3) int32 kernel offsets in (z, y, x) order."""
        grids = torch.meshgrid(*(torch.arange(k, dtype=torch.int32,
                                              device=device)
                                 for k in self.kernel_size), indexing="ij")
        return torch.stack([g.reshape(-1) for g in grids], dim=-1)


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _lin_ids(z: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
             grid: Tuple[int, int, int]) -> torch.Tensor:
    """Linearize cell coords; out of bounds -> the sentinel
    ``nz * ny * nx``."""
    nz, ny, nx = grid
    inb = (z >= 0) & (z < nz) & (y >= 0) & (y < ny) & (x >= 0) & (x < nx)
    lin = (z * ny + y) * nx + x
    return torch.where(inb, lin, torch.full_like(lin, nz * ny * nx))


def _valid_rows(num: torch.Tensor, size: int) -> torch.Tensor:
    """(B, size) bool: row < num[b]."""
    return torch.arange(size, device=num.device) < num[:, None]


def _unique_sorted_coords(lin: torch.Tensor, grid: Tuple[int, int, int],
                          max_out: int):
    """Candidate cell ids (B, M), ``nz * ny * nx`` where invalid -> the
    distinct ids ascending, the lowest ``max_out`` of them, as (coords
    (B, min(M, max_out), 3) int32 with -1 padding, count (B,) int32).
    Fewer candidates than ``max_out`` give M rows, as the JAX package's
    ``sort(...)[:max_out]`` does."""
    b, m = lin.shape
    n_cells = grid[0] * grid[1] * grid[2]
    lin_sorted = torch.sort(lin, dim=1).values
    prev = torch.cat([lin_sorted.new_full((b, 1), -1), lin_sorted[:, :-1]], 1)
    is_first = (lin_sorted != prev) & (lin_sorted < n_cells)
    rank = torch.cumsum(is_first, dim=1) - 1
    num_out = is_first.sum(dim=1).clamp(max=max_out).to(torch.int32)
    # A budget that overflows keeps the lowest cell ids.
    ckey = torch.where(is_first & (rank < max_out), lin_sorted,
                       torch.full_like(lin_sorted, n_cells))
    compact = torch.sort(ckey, dim=1).values[:, :max_out]
    keep = compact < n_cells
    zyx = torch.stack([_floordiv(compact, grid[1] * grid[2]),
                       _floordiv(compact, grid[2]) % grid[1],
                       compact % grid[2]], dim=-1)
    return torch.where(keep[..., None], zyx, -1).to(torch.int32), num_out


def build_output_coords(coords_in: torch.Tensor, num_in: torch.Tensor,
                        spec: SparseConvSpec, *, max_out: int):
    """Active output set of a strided sparse conv, sorted by cell id.

    coords_in: (B, V, 3) int32 [z, y, x], valid rows first, sorted by cell
    id; num_in (B,). Returns (coords_out (B, max_out, 3) int32 with -1
    padding, or fewer rows if there are fewer candidates, num_out (B,)
    int32). An output o is active iff some input
    lies under some tap: in = o * stride - pad + k."""
    b, v, _ = coords_in.shape
    go = spec.grid_out
    # Per axis an input reaches at most ceil(k / s) consecutive outputs.
    axes = []
    for ax in range(3):
        k, s, p = spec.kernel_size[ax], spec.stride[ax], spec.padding[ax]
        c = coords_in[..., ax]
        hi = _floordiv(c + p, s)                              # largest o
        d = torch.arange(-(-k // s), dtype=torch.int32, device=c.device)
        o = hi[..., None] - d                                 # (B, V, n_ax)
        ok = (o >= 0) & (o < go[ax]) & (c[..., None] + p - o * s <= k - 1)
        axes.append((o, ok))
    (oz, okz), (oy, oky), (ox, okx) = axes
    lin = ((oz[:, :, :, None, None] * go[1] + oy[:, :, None, :, None])
           * go[2] + ox[:, :, None, None, :])
    ok = (okz[:, :, :, None, None] & oky[:, :, None, :, None]
          & okx[:, :, None, None, :]
          & _valid_rows(num_in, v)[:, :, None, None, None])
    lin = torch.where(ok, lin, go[0] * go[1] * go[2]).reshape(b, -1)
    return _unique_sorted_coords(lin, go, max_out)


def build_footprint_coords(coords_in: torch.Tensor, num_in: torch.Tensor,
                           spec: SparseConvSpec, *, max_out: int):
    """Sparsity-retaining output set of a strided conv: each input cell
    activates only the output cell whose stride footprint contains it,
    ``o = (in + pad - (k - 1) // 2) // stride``. Shapes as
    :func:`build_output_coords`."""
    v = coords_in.shape[1]
    go = spec.grid_out
    ok = _valid_rows(num_in, v)
    os_ = []
    for ax in range(3):
        k, s, p = spec.kernel_size[ax], spec.stride[ax], spec.padding[ax]
        o = _floordiv(coords_in[..., ax] + p - (k - 1) // 2, s)
        ok = ok & (o >= 0) & (o < go[ax])
        os_.append(o)
    lin = (os_[0] * go[1] + os_[1]) * go[2] + os_[2]
    lin = torch.where(ok, lin, go[0] * go[1] * go[2])
    return _unique_sorted_coords(lin, go, max_out)


def _rank_in_sorted(lin_sorted: torch.Tensor, queries: torch.Tensor,
                    sentinel: int) -> torch.Tensor:
    """Row index of each query id in the ascending list, -1 where the
    list does not hold it or the query is the sentinel. lin_sorted
    (B, V), queries (B, ...) -> int32 of the queries' shape."""
    b, v = lin_sorted.shape
    flat = queries.reshape(b, -1)
    pos = torch.searchsorted(lin_sorted, flat).clamp(max=v - 1)
    hit = (torch.gather(lin_sorted, 1, pos) == flat) & (flat < sentinel)
    return torch.where(hit, pos, -1).to(torch.int32).reshape(queries.shape)


def build_rulebook(coords_in: torch.Tensor, num_in: torch.Tensor,
                   coords_out: torch.Tensor, num_out: torch.Tensor,
                   spec: SparseConvSpec) -> torch.Tensor:
    """Gather-form rulebook of one cloud: (K, V_out) int32, entry [k, o]
    the input row at ``coords_out[o] * stride - pad + offset[k]``, or -1.
    coords (V, 3) sorted by cell id; counts 0-dim."""
    v_in, v_out = coords_in.shape[0], coords_out.shape[0]
    dev = coords_in.device
    sentinel = spec.grid_in[0] * spec.grid_in[1] * spec.grid_in[2]
    lin_in = _lin_ids(*coords_in.unbind(-1), spec.grid_in)
    lin_in = torch.where(torch.arange(v_in, device=dev) < num_in, lin_in,
                         sentinel)
    offs = spec.offsets(dev)
    tap = [coords_out[None, :, ax] * spec.stride[ax] - spec.padding[ax]
           + offs[:, None, ax] for ax in range(3)]            # 3 x (K, V_out)
    lin_tap = _lin_ids(*tap, spec.grid_in)
    rb = _rank_in_sorted(lin_in[None], lin_tap[None], sentinel)[0]
    valid_out = torch.arange(v_out, device=dev) < num_out
    return torch.where(valid_out[None], rb, -1)


def build_scatter_rulebook(coords_in: torch.Tensor, num_in: torch.Tensor,
                           coords_out: torch.Tensor, num_out: torch.Tensor,
                           spec: SparseConvSpec) -> torch.Tensor:
    """Scatter-form rulebook: (B, K, V_in) int32, the output row each
    input voxel feeds under kernel offset k, or -1.

    coords_in (B, V_in, 3) and coords_out (B, V_out, 3) int32 [z, y, x]
    sorted by cell id, counts (B,). For offset k input i feeds the output
    at ``(in + pad - offset_k) / stride`` when that divides, lies in the
    output grid and is in the output list. The JAX package finds the
    list position with a tagged merge sort because gathers are slow on
    its machine; a binary search gives the same integers."""
    return _scatter_rulebook_offsets(coords_in, num_in, coords_out, num_out,
                                     spec, range(_num_offsets(spec)))


def _num_offsets(spec: SparseConvSpec) -> int:
    kz, ky, kx = spec.kernel_size
    return kz * ky * kx


def _scatter_rulebook_offsets(coords_in, num_in, coords_out, num_out,
                              spec: SparseConvSpec,
                              offs_idx: range) -> torch.Tensor:
    """``build_scatter_rulebook`` restricted to the kernel offsets
    ``offs_idx`` (static): (B, len(offs_idx), V_in) int32."""
    v_in, v_out = coords_in.shape[1], coords_out.shape[1]
    dev = coords_in.device
    go = spec.grid_out
    n_out_cells = go[0] * go[1] * go[2]
    lin_out = torch.where(_valid_rows(num_out, v_out),
                          _lin_ids(*coords_out.unbind(-1), go), n_out_cells)

    # Per axis with Python scalars: a stride or padding tensor would be
    # copied from the host at every call, and the copy waits for the card.
    offs = spec.offsets(dev)[offs_idx.start:offs_idx.stop:offs_idx.step]
    ok = _valid_rows(num_in, v_in)[:, None, :]
    cand = []
    for ax in range(3):
        num = (coords_in[:, None, :, ax] + spec.padding[ax]
               - offs[None, :, None, ax])                     # (B, K, V_in)
        ok = ok & (torch.remainder(num, spec.stride[ax]) == 0)
        cand.append(_floordiv(num, spec.stride[ax]))
    # _lin_ids gives out-of-grid candidates the sentinel.
    lin_q = torch.where(ok, _lin_ids(*cand, go), n_out_cells)
    return _rank_in_sorted(lin_out, lin_q, n_out_cells)


def build_subm_scatter_rulebook(coords: torch.Tensor, num: torch.Tensor,
                                spec: SparseConvSpec) -> torch.Tensor:
    """Submanifold scatter rulebook (output set = input set, stride 1):
    (B, K, V) int32, equal to ``build_scatter_rulebook(coords, num,
    coords, num, spec)``, with the search done for half the offsets.

    The centre offset is the identity on the valid rows; offset k and
    its point mirror K - 1 - k are inverse partial permutations; and each
    offset's map is increasing over its valid entries. So offsets
    0..K//2-1 go through the search, and each of their maps is inverted
    by one ``segment_paint`` launch over (B * K//2, V, 1) rows: the value
    of row i is i + 1 (0 where the map is -1), painted as a sum onto row
    ``out_of[i]`` (the running max of the map, at least 0, so the
    targets are sorted and an empty entry adds 0 to an earlier row).
    Every row of the table then holds its source + 1 or 0, and the
    mirrors are those inverses in reversed offset order. The JAX
    package's version (``lisec_tpu/ops/sparse_conv.py``) is the
    reference of this identity; neither encoder uses it."""
    from lisec_tpu_torch.ops.cuda.segment_paint import segment_paint
    b, v, _ = coords.shape
    k = _num_offsets(spec)
    if k % 2 == 0 or spec.stride != (1, 1, 1):
        raise ValueError(f"a submanifold rulebook needs an odd tap count "
                         f"and stride 1, got {spec}")
    half = k // 2
    first = _scatter_rulebook_offsets(coords, num, coords, num, spec,
                                      range(half))            # (B, half, V)
    rows = torch.arange(v, dtype=torch.int32, device=coords.device)
    ident = torch.where(_valid_rows(num, v), rows, -1)
    flat = first.reshape(b * half, v)
    src = torch.where(flat >= 0, rows.float() + 1.0, 0.0)
    tgt = torch.cummax(flat, dim=1).values.clamp_(min=0)
    table = segment_paint(src[..., None].contiguous(), tgt.contiguous(),
                          num_cells=v, num_max=0)             # (B*half, V, 1)
    inv = (torch.round(table[..., 0]).to(torch.int32) - 1).view(b, half, v)
    return torch.cat([first, ident[:, None], inv.flip(1)], dim=1)


def submanifold_sources(out_of: torch.Tensor) -> torch.Tensor:
    """The inverse of a submanifold conv's scatter rulebook, (B, K, V)
    int32: entry [b, k, t] the input row that lands on output row t under
    offset k, or -1; what ``spread_conv`` takes as ``sources``.

    For a 3x3x3 kernel with stride 1, padding 1 and the output set equal
    to the input set, the offsets in lexicographic {0, 1, 2}^3 order give
    ``offset[K - 1 - k] = 2 - offset[k]`` on every axis, so input n feeds
    t under k exactly when t feeds n under K - 1 - k:
    ``in_of[b, k, t] = out_of[b, K - 1 - k, t]``, the -1 entries (outside
    the list or the grid) included. One copy with k reversed."""
    return out_of.flip(1)


class _SpreadConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, weights, out_of, v_out, sources):
        # Each offset's product accumulated in f32 and rounded to the
        # features' dtype, the offsets added in f32 in k order.
        ctx.save_for_backward(features, weights, out_of)
        return spread_conv(features, weights, out_of, num_out=v_out,
                           sources=sources)

    @staticmethod
    def backward(ctx, g):
        features, weights, out_of = ctx.saved_tensors
        b, k, v_in = out_of.shape
        cout = weights.shape[2]
        # dz[b, k, i] = g[b, out_of[b, k, i]], zero where out_of is -1:
        # a row gather, then two plain products.
        dz = segment_unpaint(g.float().contiguous(),
                             out_of.reshape(b, k * v_in))
        dz = dz.view(b, k, v_in, cout)
        dw = torch.einsum("bvc,bkvd->kcd", features.float(), dz)
        dx = torch.einsum("bkvd,kcd->bvc", dz, weights.float())
        return dx.to(features.dtype), dw.to(weights.dtype), None, None, None


def sparse_conv3d_spread(features: torch.Tensor, out_of: torch.Tensor,
                         weights: torch.Tensor, *, v_out: int,
                         sources: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Scatter-form sparse conv ``y[out] = sum_k W_k x[in_k(out)]``.

    features (B, V_in, Cin) f32 or bf16; out_of (B, K, V_in) int32 scatter
    rulebook; weights (K, Cin, Cout) of the features' dtype; sources, where
    the caller holds it, the rulebook's inverse (B, K, v_out) int32
    (:func:`submanifold_sources`), handed to the kernel. Returns
    (B, v_out, Cout) f32. Differentiable in features and weights."""
    args = (features.contiguous(), weights.contiguous(),
            out_of.contiguous(), v_out, sources)
    if not features.is_cuda:
        return _SpreadConv.apply(*args)
    with span("spconv", features.device):   # on the card only
        return _SpreadConv.apply(*args)


def sparse_conv3d(features: torch.Tensor, rulebook: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Gather-form sparse convolution of one cloud, the plain oracle:
    features (V_in, Cin), rulebook (K, V_out), weights (K, Cin, Cout) ->
    (V_out, Cout); -1 entries read a zero row."""
    v_in, cin = features.shape
    feats_pad = torch.cat([features, features.new_zeros((1, cin))], dim=0)
    idx = torch.where(rulebook >= 0, rulebook, v_in).long()
    gathered = feats_pad[idx]                                 # (K, V_out, Cin)
    return torch.einsum("kvc,kcd->vd", gathered.float(),
                        weights.float()).to(features.dtype)
