"""The port's segment paint / unpaint, their differentiable wrappers and
the encoder's training path against the JAX package's.

The plain versions (which the port's wrappers run for CPU tensors) are
held against the Pallas kernels in interpret mode, on the same numpy
inputs. The CUDA kernels themselves are held against these plain versions
on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lisec_tpu.models.pillar_encoder import (
    FusedPillarEncoder as JaxEncoder)
from lisec_tpu.ops.pallas.pillar_paint import segment_paint as jax_paint
from lisec_tpu.ops.pallas.unpaint import segment_unpaint as jax_unpaint
from lisec_tpu.ops.scatter import segment_max_sorted as jax_segmax
from lisec_tpu.ops.scatter import segment_sum_dense as jax_segsum
from lisec_tpu_torch.models.pillar_encoder import FusedPillarEncoder
from lisec_tpu_torch.ops.cuda.segment_paint import (
    segment_offsets, segment_paint)
from lisec_tpu_torch.ops.cuda.segment_unpaint import segment_unpaint
from lisec_tpu_torch.ops.scatter import (
    segment_max_sorted, segment_sum_dense)

torch.set_num_threads(1)

GEO = dict(grid=(64, 64), pc_range=(0.0, -20.48, -3.0, 10.24, 20.48, 1.0),
           voxel_size=(0.16, 0.64))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- segment_paint ----------------------------------------------------------

# (channels the port carries, num_max): the encoder statistics, the
# segment max with its ones channel, the assigner's table.
SPLITS = {"stats": (4, 0), "segmax": (17, 16), "assigner": (3, 2)}


def _cells(case, rng, b, n, nc):
    if case == "all_invalid":
        return np.full((b, n), nc, np.int32)
    if case == "one_cell":
        return np.full((b, n), nc - 1, np.int32)
    cell = np.sort(rng.integers(0, nc + 1, (b, n)).astype(np.int32), -1)
    if case == "unsorted_tail":
        # Invalid ids need not be sorted among themselves.
        tail = cell >= nc
        cell[tail] = nc + rng.integers(0, 50, int(tail.sum()))
        cell[:, -40:] = nc + rng.integers(0, 50, (b, 40))
    return cell


def _jax_paint(vals, cell, nc, num_max, exact):
    """The Pallas kernel on the port's channels: padded to the multiple of
    8 it needs, its count channel (ones) last."""
    b, n, c = vals.shape
    width = -(-(c + 1) // 8) * 8
    padded = np.zeros((b, n, width), np.float32)
    padded[..., :c] = vals
    padded[..., width - 1] = 1.0
    out = np.asarray(jax_paint(
        jnp.asarray(padded), jnp.asarray(cell), num_cells=nc,
        num_max=num_max, count_channel=width - 1, slab=256, window=128,
        interpret=True, exact=exact))
    return out[..., :c], out[..., width - 1]


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("case,n", [
    ("random", 512), ("unsorted_tail", 512), ("all_invalid", 256),
    ("one_cell", 256), ("random", 300)])        # 300: no multiple of 128
def test_paint_plain_matches_pallas(split, case, n):
    c, num_max = SPLITS[split]
    rng = np.random.default_rng(len(split) * 100 + n)
    b, nc = 2, 600
    cell = _cells(case, rng, b, n, nc)
    vals = rng.normal(size=(b, n, c)).astype(np.float32)
    vals[..., c - 1] = 1.0                      # the callers' ones channel
    got = segment_paint(_t(vals), _t(cell), num_cells=nc,
                        num_max=num_max).numpy()
    assert got.shape == (b, nc, c)
    # In two parts: the same table, each part dense.
    head, tail = segment_paint(_t(vals), _t(cell), num_cells=nc,
                               num_max=num_max, split=c - 1)
    assert head.is_contiguous() and tail.is_contiguous()
    np.testing.assert_array_equal(head.numpy(), got[..., :c - 1])
    np.testing.assert_array_equal(tail.numpy(), got[..., c - 1:])

    # The JAX kernel is fed ids clamped to num_cells (its contract:
    # ascending ids); the port takes the unsorted invalid tail as it is.
    ids = np.minimum(cell, nc)
    want, count = _jax_paint(vals, ids, nc, num_max, exact=True)
    # Max channels (-3e38 where empty) and counts exactly; sums to the
    # order of summation (f32 on the JAX side, f64 rounded once here).
    np.testing.assert_array_equal(got[..., :num_max], want[..., :num_max])
    np.testing.assert_array_equal(got[..., c - 1], count)
    np.testing.assert_allclose(got[..., num_max:], want[..., num_max:],
                               rtol=1e-5, atol=1e-5)
    occupied = count > 0
    assert (got[..., :num_max][~occupied] == np.float32(-3.0e38)).all()
    assert (got[..., num_max:][~occupied] == 0).all()
    if case == "all_invalid":
        assert not occupied.any()
    if case == "one_cell":
        assert occupied.sum() == b and occupied[:, nc - 1].all()

    # The default (two-term bf16) routing of the JAX kernel: 2^-18.
    want2, _ = _jax_paint(vals, ids, nc, num_max, exact=False)
    np.testing.assert_allclose(got[occupied], want2[occupied], rtol=2e-5,
                               atol=2e-5)


def test_paint_offsets_and_checks():
    cell = _t(np.array([[-2, 0, 0, 3, 3, 3, 7, 9]], np.int32))
    offs = segment_offsets(cell, 5)
    assert offs.tolist() == [[1, 3, 3, 3, 6, 6]]
    vals = torch.ones((1, 8, 2))
    out = segment_paint(vals, cell, num_cells=5, num_max=1)
    assert out[0, :, 1].tolist() == [2.0, 0.0, 0.0, 3.0, 0.0]
    with pytest.raises(ValueError):
        segment_paint(vals.double(), cell, num_cells=5, num_max=1)
    with pytest.raises(ValueError):
        segment_paint(vals, cell.long(), num_cells=5, num_max=1)
    with pytest.raises(ValueError):
        segment_paint(vals, cell, num_cells=5, num_max=3)
    with pytest.raises(ValueError):
        segment_paint(vals.transpose(1, 2), cell, num_cells=5, num_max=1)
    for split in (0, 2):
        with pytest.raises(ValueError):
            segment_paint(vals, cell, num_cells=5, num_max=1, split=split)


# -- segment_unpaint --------------------------------------------------------

def _unpaint_oracle(table, cell):
    b, n = cell.shape
    out = np.zeros((b, n, table.shape[2]), np.float32)
    for bi in range(b):
        ok = (cell[bi] >= 0) & (cell[bi] < table.shape[1])
        out[bi, ok] = table[bi, cell[bi, ok]]
    return out


@pytest.mark.parametrize("case", ["random", "unaligned_runs"])
@pytest.mark.parametrize("c", [128, 8])
def test_unpaint_plain_matches_pallas(case, c):
    rng = np.random.default_rng(c)
    if case == "random":
        b, n, r = 2, 512, 1000
        cell = np.sort(rng.integers(0, r + 300, (b, n)).astype(np.int32), -1)
    else:
        # Long equal-cell runs, so that the JAX kernel's ranges start and
        # end inside its windows (test_pillar_paint.py's case).
        b, n, r = 1, 512, 700
        runs = np.repeat(np.arange(0, 700, 37), 30)[:n]
        cell = np.sort(runs.astype(np.int32))[None]
    table = rng.normal(size=(b, r, c)).astype(np.float32)
    got = segment_unpaint(_t(table), _t(cell)).numpy()
    np.testing.assert_array_equal(got, _unpaint_oracle(table, cell))
    kw = dict(num_rows=r, slab=128, window=128, interpret=True)
    exact = np.asarray(jax_unpaint(jnp.asarray(table), jnp.asarray(cell),
                                   exact=True, **kw))
    np.testing.assert_array_equal(got, exact)
    default = np.asarray(jax_unpaint(jnp.asarray(table), jnp.asarray(cell),
                                     **kw))
    np.testing.assert_allclose(got, default, rtol=2e-5, atol=2e-5)


def test_unpaint_views_and_checks():
    rng = np.random.default_rng(0)
    wide = _t(rng.normal(size=(2, 50, 7)).astype(np.float32))
    cell = _t(np.array([[0, 3, 49, 50, -1], [1, 1, 2, 60, 7]], np.int32))
    got = segment_unpaint(wide, cell)                 # C no multiple of 4
    want = _unpaint_oracle(wide.numpy(), cell.numpy())
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0, 3:] == 0).all() and (got[1, 3] == 0).all()
    # Views are refused: the segment max hands in dense tables.
    with pytest.raises(ValueError):
        segment_unpaint(wide[..., :5], cell)
    with pytest.raises(ValueError):
        segment_unpaint(wide.transpose(1, 2), cell)
    with pytest.raises(ValueError):
        segment_unpaint(wide[:, :30], cell)
    with pytest.raises(ValueError):
        segment_unpaint(wide, cell.long())
    with pytest.raises(ValueError):
        segment_unpaint(wide.double(), cell)


# -- segment_max_sorted / segment_sum_dense ---------------------------------

def test_segment_max_sorted_value_and_grad():
    rng = np.random.default_rng(3)
    b, n, c, nc = 2, 512, 64, 600
    cell = np.sort(rng.integers(0, nc + 1, (b, n)).astype(np.int32), -1)
    h = rng.normal(size=(b, n, c)).astype(np.float32)
    wts = np.arange(c, dtype=np.float32)

    def jax_loss(hh):
        canvas, count = jax_segmax(hh, jnp.asarray(cell), nc, True)
        canvas = jnp.where(count[..., None] > 0, canvas, 0.0)
        return jnp.sum(canvas * wts), (canvas, count)
    (_, (want, want_count)), want_g = jax.value_and_grad(
        jax_loss, has_aux=True)(jnp.asarray(h))

    ht = _t(h).requires_grad_()
    canvas, count = segment_max_sorted(ht, _t(cell), nc)
    assert not count.requires_grad and canvas.is_contiguous()
    masked = torch.where(count[..., None] > 0, canvas, 0.0)
    (masked * _t(wts)).sum().backward()
    np.testing.assert_array_equal(count.numpy(), np.asarray(want_count))
    # Empty cells hold -3e38 in both.
    np.testing.assert_array_equal(canvas.detach().numpy()[count.numpy() == 0],
                                  np.float32(-3.0e38))
    # The JAX tests' own tolerance (test_pillar_paint.py).
    np.testing.assert_allclose(masked.detach().numpy(), np.asarray(want),
                               atol=1e-4)
    got_g, want_g = ht.grad.numpy(), np.asarray(want_g)
    off = np.abs(got_g - want_g) > 1e-4
    if off.any():
        # The JAX backward compares the leading 17 mantissa bits, the
        # port exact f32: they may differ only where a value is not the
        # max but agrees with it in those bits.
        mx = segment_unpaint(canvas.detach(), _t(cell)).numpy()
        assert (np.abs(h - mx)[off] <= 2.0 ** -16 * np.abs(mx)[off]).all()
        assert off.sum() < 10


def test_segment_max_sorted_ties_get_whole_cotangent():
    rng = np.random.default_rng(4)
    b, n, c, nc = 2, 256, 8, 20
    cell = np.sort(rng.integers(0, nc + 2, (b, n)).astype(np.int32), -1)
    # bf16-valued features from a few levels: ties everywhere.
    h = rng.integers(0, 4, (b, n, c)).astype(np.float32) * 0.25
    g = rng.normal(size=(b, nc, c)).astype(np.float32)

    def jax_loss(hh):
        canvas, _ = jax_segmax(hh, jnp.asarray(cell), nc, True)
        return jnp.sum(canvas * g)
    want_g = np.asarray(jax.grad(jax_loss)(jnp.asarray(h, jnp.bfloat16)),
                        np.float32)

    ht = _t(h).bfloat16().requires_grad_()
    canvas, _ = segment_max_sorted(ht, _t(cell), nc)
    (canvas * _t(g)).sum().backward()
    got_g = ht.grad.float().numpy()
    assert ht.grad.dtype == torch.bfloat16

    # By hand: every row equal to its cell's max takes the whole g.
    expect = np.zeros_like(h)
    tied_rows = 0
    for bi in range(b):
        for ci in range(nc):
            rows = np.nonzero(cell[bi] == ci)[0]
            if len(rows):
                is_max = h[bi, rows] == h[bi, rows].max(0)
                tied_rows += int((is_max.sum(0) > 1).sum())
                expect[bi, rows] = np.where(is_max, g[bi, ci], 0.0)
    assert tied_rows > 50
    expect = _t(expect).bfloat16().float().numpy()
    np.testing.assert_array_equal(got_g, expect)
    # The JAX cotangent rides a two-term bf16 routing (2^-17) and is then
    # rounded to bf16: within one bf16 ulp.
    np.testing.assert_allclose(got_g, want_g, rtol=2.0 ** -7, atol=1e-6)


def test_segment_sum_dense_value_and_grad():
    rng = np.random.default_rng(5)
    b, n, c, nc = 2, 256, 16, 600
    cells = np.stack([np.sort(rng.choice(nc, n, replace=False))
                      for _ in range(b)]).astype(np.int32)
    cells[:, -40:] = nc                          # invalid tail
    h = rng.normal(size=(b, n, c)).astype(np.float32)
    wts = np.arange(c, dtype=np.float32)

    def jax_loss(hh):
        tab, cnt = jax_segsum(hh, jnp.asarray(cells), nc, True)
        return jnp.sum(tab * wts), (tab, cnt)
    (_, (want, want_cnt)), want_g = jax.value_and_grad(
        jax_loss, has_aux=True)(jnp.asarray(h))

    ht = _t(h).requires_grad_()
    tab, cnt = segment_sum_dense(ht, _t(cells), nc)
    (tab * _t(wts)).sum().backward()
    np.testing.assert_allclose(tab.detach().numpy(), np.asarray(want),
                               atol=1e-4)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    assert float(cnt.sum()) == b * (n - 40)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_g),
                               atol=1e-4)
    assert (ht.grad.numpy()[:, -40:] == 0).all()


# -- the encoder's training path --------------------------------------------

def _encoder_inputs(rng, b=2, n=1024):
    pts = rng.uniform([-1, -25, -4, 0], [12, 25, 2, 1],
                      (b, n, 4)).astype(np.float32)
    mask = rng.random((b, n)) > 0.1
    return pts, mask


@pytest.mark.parametrize("fast_train", [True, False])
def test_encoder_train_path_matches_jax(fast_train):
    """Against ``_train_pallas_path`` (fast_train) and the scatter-based
    ``_reference_path``: canvas, new running statistics and the gradients
    of kernel, scale and bias. Masked and out-of-range rows count in the
    batch statistics (as zero rows) in all three."""
    rng = np.random.default_rng(6)
    c = 64
    pts, mask = _encoder_inputs(rng)
    enc = JaxEncoder(num_filters=c, dtype=jnp.float32, fast_train=fast_train,
                     **GEO)
    v = enc.init(jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask))
    params = {k: np.asarray(a) for k, a in v["params"].items()}
    params["scale"] = (0.5 + rng.random(c)).astype(np.float32)
    params["bias"] = (rng.normal(size=c) * 0.1).astype(np.float32)
    stats = {"mean": (rng.normal(size=c) * 0.1).astype(np.float32),
             "var": (1.0 + rng.random(c)).astype(np.float32)}

    def jax_loss(p):
        out, mut = jax.jit(lambda pp: enc.apply(
            {"params": pp, "batch_stats": stats}, jnp.asarray(pts),
            jnp.asarray(mask), train=True, mutable=["batch_stats"]))(p)
        return jnp.sum(out * out), (out, mut["batch_stats"])
    (_, (want, want_stats)), want_g = jax.value_and_grad(
        jax_loss, has_aux=True)(params)

    port = FusedPillarEncoder(num_filters=c, dtype=torch.float32, **GEO)
    port.load_state_dict({k: _t(a) for k, a in {**params, **stats}.items()},
                         strict=True)
    port.train()
    out = port(_t(pts), _t(mask))
    (out * out).sum().backward()
    assert out.shape == (2, 64 * 64, c)
    # 1e-4 against the scatter-based reference path (the JAX tests' own
    # tolerance between their two paths). The JAX Pallas path routes the
    # per-cell xyz sums through two bf16 terms (its statistics paint runs
    # with exact=False), so its cell means carry up to 2^-17 * 25 m =
    # 2e-4 of error, which the PFN weights and the BN scale (both O(1))
    # pass on to the canvas; the port's paint is exact.
    tol = 1e-3 if fast_train else 1e-4
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(want).reshape(out.shape),
        rtol=tol, atol=tol)
    np.testing.assert_allclose(port.mean.numpy(),
                               np.asarray(want_stats["mean"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port.var.numpy(),
                               np.asarray(want_stats["var"]),
                               rtol=1e-4, atol=1e-5)
    # The statistics moved, and by the whole batch (B * N rows).
    assert not np.allclose(port.mean.numpy(), stats["mean"])
    # Gradients: 2e-3 (the JAX tests' own); against the Pallas path an
    # element that is a sum over ~2,000 points of terms that large also
    # collects its routing error, 1e-5 of the largest gradient.
    for k in ("kernel", "scale", "bias"):
        want_k = np.asarray(want_g[k])
        extra = 1e-5 * float(np.abs(want_k).max()) if fast_train else 0.0
        np.testing.assert_allclose(
            getattr(port, k).grad.numpy(), want_k, rtol=2e-3,
            atol=2e-3 + extra, err_msg=k)


def test_encoder_masked_rows_count_in_batch_statistics():
    rng = np.random.default_rng(7)
    pts, mask = _encoder_inputs(rng, n=512)
    port = FusedPillarEncoder(num_filters=32, dtype=torch.float32, **GEO)
    with torch.no_grad():
        port.kernel.copy_(_t(rng.normal(size=(9, 32)).astype(np.float32)))
    port.train()
    port(_t(pts), _t(mask))
    cell_s, feats = port.decorate_sorted(_t(pts), _t(mask))
    h = feats @ port.kernel.detach()
    assert (feats[cell_s >= 64 * 64] == 0).all()
    assert (cell_s >= 64 * 64).sum() > 100
    np.testing.assert_allclose(port.mean.numpy(),
                               0.01 * h.mean((0, 1)).numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(
        port.var.numpy(), 0.99 + 0.01 * h.var((0, 1), unbiased=False).numpy(),
        rtol=1e-6)
    # eval() mode takes the inference kernel's path and leaves them alone.
    port.eval()
    before = port.mean.clone()
    with torch.no_grad():
        port(_t(pts), _t(mask))
    assert torch.equal(port.mean, before)


def test_encoder_train_bf16_runs_in_compute_dtype():
    rng = np.random.default_rng(8)
    pts, mask = _encoder_inputs(rng, n=512)
    port = FusedPillarEncoder(num_filters=32, dtype=torch.bfloat16, **GEO)
    with torch.no_grad():
        port.kernel.copy_(_t(rng.normal(size=(9, 32)).astype(np.float32)))
    port.train()
    out = port(_t(pts), _t(mask))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    out.float().sum().backward()
    assert port.kernel.grad.dtype == torch.float32
    assert float(port.kernel.grad.abs().sum()) > 0
