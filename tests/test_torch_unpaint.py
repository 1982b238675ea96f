"""The unpaint source's three entries against the JAX package.

``segment_unpaint`` (the row gather, with its output type),
``segment_max_backward`` (the segment max's VJP in one launch) and
``pillar_decorate`` (the encoder's decoration after its C = 4 gather) in
``lisec_tpu_torch/ops/cuda/segment_unpaint.py``: their plain versions,
which the wrappers run for CPU tensors, are held against the Pallas
unpaint in interpret mode, the JAX ``segment_max_sorted`` gradient and a
numpy transcription of the JAX train path's decoration, on the same numpy
inputs. The CUDA kernels themselves are held bit-equal to these plain
versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lisec_tpu.ops.pallas.unpaint import segment_unpaint as jax_unpaint
from lisec_tpu.ops.scatter import segment_max_sorted as jax_segmax
from lisec_tpu_torch.ops.cuda.encoder_kernel import pillar_cells
from lisec_tpu_torch.ops.cuda.segment_unpaint import (
    pillar_decorate, segment_max_backward, segment_unpaint)
from lisec_tpu_torch.ops.scatter import segment_max_sorted

torch.set_num_threads(1)

GEO = dict(grid=(64, 64), pc_range=(0.0, -20.48, -3.0, 10.24, 20.48, 1.0),
           voxel_size=(0.16, 0.64))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ids(case, rng, b, n, r):
    """(b, n) int32 ids: ascending over the table with an invalid tail
    (>= r), and for the edge cases negative ids at the head, one cell
    holding the whole cloud, or every id invalid."""
    cell = np.sort(rng.integers(0, r + r // 4, (b, n)), -1)
    if case == "negative":
        cell[:, : n // 8] = -rng.integers(1, 40, (b, n // 8))
        cell = np.sort(cell, -1)
    elif case == "one_cell":
        cell[:] = r - 1
    elif case == "all_invalid":
        cell[:] = r + rng.integers(0, 9, (b, n))
    return cell.astype(np.int32)


def _np_gather(table, cell):
    out = np.zeros(cell.shape + table.shape[2:], np.float32)
    for bi in range(cell.shape[0]):
        ok = (cell[bi] >= 0) & (cell[bi] < table.shape[1])
        out[bi, ok] = table[bi, cell[bi, ok]]
    return out


# -- segment_unpaint --------------------------------------------------------

@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("case", ["random", "one_cell", "all_invalid"])
def test_unpaint_matches_pallas_exact_and_casts_like_to(case, c):
    rng = np.random.default_rng(c + len(case))
    b, n, r = 2, 256, 300
    cell = _ids(case, rng, b, n, r)
    table = rng.normal(size=(b, r, c)).astype(np.float32)
    got = segment_unpaint(_t(table), _t(cell))
    want = np.asarray(jax_unpaint(jnp.asarray(table), jnp.asarray(cell),
                                  num_rows=r, slab=128, window=128,
                                  interpret=True, exact=True))
    np.testing.assert_array_equal(got.numpy(), want)
    # The bf16 output: the f32 rows rounded to nearest even, as .to and
    # JAX's astype round them.
    half = segment_unpaint(_t(table), _t(cell), out_dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16 and half.shape == (b, n, c)
    assert torch.equal(half, got.to(torch.bfloat16))
    np.testing.assert_array_equal(
        half.float().numpy(),
        np.asarray(jnp.asarray(want).astype(jnp.bfloat16), np.float32))


@pytest.mark.parametrize("c", [4, 65])
def test_unpaint_negative_ids_and_odd_widths(c):
    """Ids below 0 and at or above R read zero rows (the Pallas kernel
    takes only ids >= 0, so a numpy oracle holds these)."""
    rng = np.random.default_rng(c)
    cell = _ids("negative", rng, 3, 200, 150)
    table = rng.normal(size=(3, 150, c)).astype(np.float32)
    got = segment_unpaint(_t(table), _t(cell))
    np.testing.assert_array_equal(got.numpy(), _np_gather(table, cell))
    assert (got.numpy()[cell < 0] == 0).all()


# -- segment_max_backward ---------------------------------------------------

def _old_backward(h, cell, canvas, g):
    """The segment max's backward as it was composed before it became one
    entry: two gathers, the compare, ``where`` and the cast."""
    mx = segment_unpaint(canvas, cell)
    gp = segment_unpaint(g, cell)
    return torch.where(h.float() == mx, gp, 0.0).to(h.dtype)


@pytest.mark.parametrize("c", [4, 16, 64, 65])
@pytest.mark.parametrize("inputs", ["f32", "bf16_ties"])
@pytest.mark.parametrize("case", ["random", "negative", "one_cell",
                                  "all_invalid"])
def test_segment_max_backward_equals_old_composition(case, inputs, c):
    rng = np.random.default_rng(c * 7 + len(case) + len(inputs))
    b, n, r = 2, 192, 60
    cell = _t(_ids(case, rng, b, n, r))
    if inputs == "f32":
        h = _t(rng.normal(size=(b, n, c)).astype(np.float32))
    else:
        h = _t(rng.integers(0, 4, (b, n, c)).astype(np.float32)
               * 0.25).bfloat16()
    canvas, _ = segment_max_sorted(h, cell, r)
    g = _t(rng.normal(size=(b, r, c)).astype(np.float32))
    got = segment_max_backward(h, cell, canvas, g)
    want = _old_backward(h, cell, canvas, g)
    assert got.dtype == h.dtype and got.shape == h.shape
    assert torch.equal(got, want)
    ok = ((cell >= 0) & (cell < r))[..., None]
    assert (got.float()[~ok.expand_as(got)] == 0).all()
    if inputs == "bf16_ties" and case == "random":
        # Ties: more rows take a cotangent than there are (cell, channel)
        # pairs with one.
        assert int((got != 0).sum()) > int((canvas > -1e38).sum())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("inputs", ["f32", "bf16_ties"])
def test_segment_max_sorted_grad_matches_jax(inputs, seed):
    """Through ``segment_max_sorted``, against the JAX gradient, with the
    tolerances of ``test_torch_paint.py``'s segment-max tests. One shape,
    so that the Pallas kernels compile once in interpret mode."""
    rng = np.random.default_rng(seed + 10 * len(inputs))
    b, n, nc, c = 2, 256, 40, 16
    cell = np.sort(rng.integers(0, nc + 2, (b, n)).astype(np.int32), -1)
    g = rng.normal(size=(b, nc, c)).astype(np.float32)
    if inputs == "f32":
        h = rng.normal(size=(b, n, c)).astype(np.float32)
        hj, ht = jnp.asarray(h), _t(h)
    else:
        h = rng.integers(0, 4, (b, n, c)).astype(np.float32) * 0.25
        hj, ht = jnp.asarray(h, jnp.bfloat16), _t(h).bfloat16()

    def jax_loss(hh):
        canvas, count = jax_segmax(hh, jnp.asarray(cell), nc, True)
        return jnp.sum(jnp.where(count[..., None] > 0, canvas, 0.0) * g)
    want_g = np.asarray(jax.grad(jax_loss)(hj), np.float32)

    ht.requires_grad_()
    canvas, count = segment_max_sorted(ht, _t(cell), nc)
    (torch.where(count[..., None] > 0, canvas, 0.0) * _t(g)).sum().backward()
    got_g = ht.grad.float().numpy()
    assert ht.grad.dtype == ht.dtype
    if inputs == "bf16_ties":
        # The JAX cotangent rides a two-term bf16 routing (2^-17) and is
        # then rounded to bf16: within one bf16 ulp.
        np.testing.assert_allclose(got_g, want_g, rtol=2.0 ** -7, atol=1e-6)
        return
    off = np.abs(got_g - want_g) > 1e-4
    if off.any():
        # The JAX backward compares the leading 17 mantissa bits, the
        # port exact f32: they may differ only where a value is not the
        # max but agrees with it in those bits.
        mx = segment_unpaint(canvas.detach(), _t(cell)).numpy()
        assert (np.abs(h - mx)[off] <= 2.0 ** -16 * np.abs(mx)[off]).all()
        assert off.sum() < 10


# -- pillar_decorate --------------------------------------------------------

def _np_decorate(pts_s, cell_s, stats4, grid, voxel_size, pc_range):
    """The gather and arithmetic of the JAX train path's decoration
    (``lisec_tpu/models/pillar_encoder.py``, ``_train_pallas_path``) in
    numpy f32: returns (the gathered stats rows, the cell column and row,
    feats)."""
    nx, ny = grid
    ncells = nx * ny
    f32 = np.float32
    xs, ys, zs, rs = (pts_s[..., k] for k in range(4))
    per_pt = np.take_along_axis(
        stats4, np.minimum(cell_s, ncells - 1)[..., None], axis=1)
    per_pt = np.where((cell_s < ncells)[..., None], per_pt, f32(0.0))
    cnt_pt = np.maximum(per_pt[..., 3:], f32(1.0))
    mean_pt = per_pt[..., :3] / cnt_pt
    cell_c = np.minimum(cell_s, ncells - 1)
    col, row = cell_c % nx, cell_c // nx
    px = (col.astype(f32) + f32(0.5)) * f32(voxel_size[0]) + f32(pc_range[0])
    py = (row.astype(f32) + f32(0.5)) * f32(voxel_size[1]) + f32(pc_range[1])
    ones = (cell_s < ncells).astype(f32)[..., None]
    xyz_s = np.stack([xs, ys, zs], -1)
    feats = np.concatenate([np.stack([xs, ys, zs, rs], -1), xyz_s - mean_pt,
                            np.stack([xs - px, ys - py], -1)], -1) * ones
    return per_pt, col, row, feats.astype(f32)


def _decorate_inputs(case, rng, b=2, n=512):
    """Points sorted by cell (the port's ``pillar_cells``), and their exact
    per-cell xyz sums and counts (f64 sums rounded once, in numpy)."""
    pts = rng.uniform([-1, -22, -4, 0], [11, 22, 2, 1],
                      (b, n, 4)).astype(np.float32)
    mask = rng.random((b, n)) > 0.1
    nx, ny = GEO["grid"]
    vx, vy = GEO["voxel_size"]
    x0, y0 = GEO["pc_range"][:2]
    if case == "cell_edges":
        # x and y exactly on cell edges.
        pts[..., 0] = (x0 + rng.integers(0, nx + 1, (b, n)) * vx).astype(
            np.float32)
        pts[..., 1] = (y0 + rng.integers(0, ny + 1, (b, n)) * vy).astype(
            np.float32)
        pts[..., 2] = 0.0
    elif case == "one_cell":
        pts[..., 0], pts[..., 1], pts[..., 2] = 5.01, 0.3, 0.0
        mask[:] = True
    elif case == "all_masked":
        mask[0] = False
    cell, _, _, _ = pillar_cells(_t(pts), _t(mask), **GEO)
    cell_s, order = torch.sort(cell, dim=1, stable=True)
    pts_s = np.take_along_axis(pts, order.numpy()[..., None], axis=1)
    cell_np = cell_s.numpy()
    ncells = nx * ny
    acc = np.zeros((b, ncells + 1, 4), np.float64)
    valid = cell_np < ncells
    for bi in range(b):
        np.add.at(acc[bi], cell_np[bi], np.concatenate(
            [pts_s[bi, :, :3], np.ones((n, 1), np.float32)], -1)
            * valid[bi, :, None])
    return pts_s, cell_np, acc[:, :ncells].astype(np.float32)


@pytest.mark.parametrize("case", ["random", "cell_edges", "one_cell",
                                  "all_masked"])
def test_decorate_matches_jax_transcription(case):
    rng = np.random.default_rng(len(case))
    pts_s, cell_s, stats = _decorate_inputs(case, rng)
    got = pillar_decorate(_t(pts_s), _t(cell_s), _t(stats), **GEO)
    per_pt, col, row, want = _np_decorate(pts_s, cell_s, stats, **GEO)
    assert got.shape == pts_s.shape[:2] + (9,) and got.dtype == torch.float32
    # The gathered cell rows (sums and counts) and the cell's column and
    # row: exact.
    ncells = GEO["grid"][0] * GEO["grid"][1]
    np.testing.assert_array_equal(
        segment_unpaint(_t(stats), _t(cell_s)).numpy(), per_pt)
    cell_c = np.minimum(cell_s, ncells - 1)
    np.testing.assert_array_equal(cell_c % GEO["grid"][0], col)
    np.testing.assert_array_equal(cell_c // GEO["grid"][0], row)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert (got.numpy()[cell_s >= ncells] == 0).all()
    if case == "all_masked":
        assert (got.numpy()[0] == 0).all()
    if case == "one_cell":
        assert len(np.unique(cell_s)) == 1 and (cell_s < ncells).all()


def test_decorate_negative_ids_follow_torch_floor_division():
    """Ids below 0 (no caller makes them) still give the plain version's
    answer: a zero stats row, the centre from Python-style % and //, and
    the row kept (it is below nx * ny)."""
    nx, ny = GEO["grid"]
    pts = _t(np.full((1, 3, 4), 2.0, np.float32))
    cell = _t(np.array([[-70, -1, nx * ny]], np.int32))
    stats = torch.ones((1, nx * ny, 4))
    got = pillar_decorate(pts, cell, stats, **GEO)
    vx, vy = GEO["voxel_size"]
    x0, y0 = GEO["pc_range"][:2]
    for i, (col, row) in enumerate([(-70 % nx, -70 // nx), (nx - 1, -1)]):
        px = np.float32((np.float32(col) + np.float32(0.5)) * np.float32(vx)
                        + np.float32(x0))
        py = np.float32((np.float32(row) + np.float32(0.5)) * np.float32(vy)
                        + np.float32(y0))
        np.testing.assert_array_equal(
            got[0, i].numpy(), np.float32([2, 2, 2, 2, 2, 2, 2, 2 - px,
                                           2 - py]))
    assert (got[0, 2] == 0).all()


# -- refusals -----------------------------------------------------------------

def test_entries_refuse_what_the_kernels_cannot_take():
    rng = np.random.default_rng(0)
    table = _t(rng.normal(size=(2, 50, 8)).astype(np.float32))
    cell = _t(np.sort(rng.integers(0, 60, (2, 30)), -1).astype(np.int32))
    h = _t(rng.normal(size=(2, 30, 8)).astype(np.float32))
    bad_unpaint = [
        dict(table=table[..., :5]), dict(table=table.transpose(1, 2)),
        dict(table=table.double()), dict(cell_sorted=cell.long()),
        dict(cell_sorted=cell[:1]), dict(cell_sorted=cell.t()),
        dict(table=table[:, :0]), dict(out_dtype=torch.float16)]
    for kw in bad_unpaint:
        args = {**dict(table=table, cell_sorted=cell), **kw}
        with pytest.raises(ValueError):
            segment_unpaint(**args)
    bad_backward = [
        dict(h=h.half()), dict(h=h[:, :20]), dict(h=h[..., :4]),
        dict(h=h.transpose(0, 1).contiguous().transpose(0, 1)),
        dict(canvas=table[:, :40]), dict(g_canvas=table.double()),
        dict(g_canvas=table[:, :40]), dict(cell_sorted=cell.long())]
    for kw in bad_backward:
        args = {**dict(h=h, cell_sorted=cell, canvas=table,
                       g_canvas=table), **kw}
        with pytest.raises(ValueError):
            segment_max_backward(**args)
    nx, ny = GEO["grid"]
    pts = _t(rng.normal(size=(2, 30, 4)).astype(np.float32))
    stats = torch.zeros((2, nx * ny, 4))
    bad_decorate = [
        dict(pts_s=pts[..., :3].contiguous()), dict(pts_s=pts.double()),
        dict(stats=stats[:, :-1]), dict(stats=stats[..., :3].contiguous()),
        dict(cell_s=cell.long()), dict(pts_s=pts[:, :10].contiguous()),
        dict(stats=torch.zeros((2, 4, nx * ny)).transpose(1, 2))]
    for kw in bad_decorate:
        args = {**dict(pts_s=pts, cell_s=cell, stats=stats), **kw}
        with pytest.raises(ValueError):
            pillar_decorate(**args, **GEO)
    # What they take, they compute.
    assert segment_unpaint(table, cell).shape == (2, 30, 8)
    assert segment_max_backward(h, cell, table, table).shape == h.shape
    assert pillar_decorate(pts, cell, stats, **GEO).shape == (2, 30, 9)
