"""The port's spread-accumulate, output sets, rulebooks and scatter-form sparse
conv against the JAX package's.

Inputs are made with numpy from seeds. The JAX Pallas kernel runs in
interpret mode; the port runs on CPU tensors, where its wrappers compute
their plain versions. Integers (coords, counts, rulebooks) must be equal
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lisec_tpu.ops import sparse_conv as jsc
from lisec_tpu.ops.pallas.spread_kernel import (
    spread_accumulate as jax_spread_accumulate)
from lisec_tpu_torch.ops import sparse_conv as psc
from lisec_tpu_torch.ops.cuda.spread_accumulate import (
    spread_accumulate, spread_accumulate_reference)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the kernel's plain version against the Pallas kernel --------------------

def _jax_spread(vals, targets, num_out):
    """The Pallas kernel on the port's inputs, prepared as the JAX
    package's ``_spread_conv`` prepares them: dropped rows zeroed, targets
    made ascending with a running max, channel-leading streams padded to a
    multiple of 8 channels. vals (B, K, N, C), targets (B, K, N)."""
    c = vals.shape[-1]
    valid = (targets >= 0) & (targets < num_out)
    z = jnp.where(valid[..., None], jnp.asarray(vals), 0)
    z = jnp.pad(z.transpose(0, 1, 3, 2),
                ((0, 0), (0, 0), (0, -c % 8), (0, 0)))
    tgt = jax.lax.cummax(jnp.where(valid, jnp.asarray(targets), -1), axis=2)
    out = jax_spread_accumulate(z, jnp.maximum(tgt, 0).astype(jnp.int32),
                                num_out=num_out, slab=256, window=128,
                                interpret=True)
    return np.asarray(out)[..., :c]


def _numpy_spread(vals, targets, num_out):
    b, k, n, c = vals.shape
    out = np.zeros((b, num_out, c), np.float64)
    for bi in range(b):
        for ki in range(k):
            ok = (targets[bi, ki] >= 0) & (targets[bi, ki] < num_out)
            np.add.at(out[bi], targets[bi, ki][ok],
                      vals[bi, ki][ok].astype(np.float64))
    return out


def _streams(rng, b, k, n, num_out, case):
    """Ascending targets, distinct per (b, k), with dropped rows among
    them."""
    tg = np.full((b, k, n), -1, np.int32)
    for bi in range(b):
        for ki in range(k):
            if case == "all_offsets_hit_every_row":
                tg[bi, ki, :num_out] = np.arange(num_out)
                continue
            if case == "empty_rows" and (bi + ki) % 2:
                tg[bi, ki] = num_out + rng.integers(0, 5, n)
                continue
            m = int(rng.integers(n // 4, 2 * num_out // 3))
            pos = np.sort(rng.choice(n, m, replace=False))
            tg[bi, ki, pos] = np.sort(rng.choice(num_out, m, replace=False))
            if case == "dropped":
                # Ids past the table at the end of the stream, -1 inside.
                tail = rng.choice(np.flatnonzero(tg[bi, ki] < 0), 10,
                                  replace=False)
                tg[bi, ki, tail] = num_out + rng.integers(0, 9, 10)
    return tg


@pytest.mark.parametrize("case,dtype,c", [
    ("collisions", "float32", 16), ("collisions", "bfloat16", 16),
    ("dropped", "float32", 8), ("dropped", "bfloat16", 32),
    ("empty_rows", "float32", 8), ("empty_rows", "bfloat16", 8),
    ("all_offsets_hit_every_row", "bfloat16", 8),
    ("index_stream", "float32", 1)])
def test_spread_accumulate_matches_pallas_kernel(case, dtype, c):
    rng = np.random.default_rng(len(case) + c)
    b, k, n, num_out = 2, 5, 384, 300       # 300 is no multiple of the slab
    tg = _streams(rng, b, k, n, num_out, case)
    if case == "index_stream":
        # The backward's inverse-map stream: the row index + 1.
        vals = np.broadcast_to(
            np.arange(1, n + 1, dtype=np.float32)[None, None, :, None],
            (b, k, n, 1)).copy()
    else:
        vals = rng.normal(size=(b, k, n, c)).astype(np.float32)
    tv = _t(vals).to(getattr(torch, dtype))
    jv = jnp.asarray(vals).astype(dtype)
    got = spread_accumulate(tv, _t(tg), num_out=num_out)
    assert got.dtype == torch.float32 and got.shape == (b, num_out, c)
    assert torch.equal(got, spread_accumulate_reference(
        tv, _t(tg), num_out=num_out))
    got = got.numpy()
    exact = _numpy_spread(tv.float().numpy(), tg, num_out)
    want = _jax_spread(jv, tg, num_out)
    hits = (_numpy_spread(np.ones((b, k, n, 1), np.float32), tg, num_out)
            [..., 0])
    assert hits.max() > 1 or case == "index_stream"      # collisions over k
    assert (hits == 0).any() or case == "all_offsets_hit_every_row"
    assert (got[hits == 0] == 0).all()
    # The port adds exact values in f32 in k order: 1e-6 of the largest
    # sum against f64.
    scale = np.abs(exact).max()
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6 * scale)
    # bf16 streams route exactly through the Pallas kernel too (the same
    # f32 additions in the same order). f32 streams go through two bf16
    # terms there, about 2^-17 of each of up to K values: 2e-5 of the
    # largest sum.
    tol = 1e-6 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_spread_accumulate_takes_unsorted_targets_and_checks_inputs():
    rng = np.random.default_rng(3)
    b, k, n, c, num_out = 2, 3, 50, 4, 40
    tg = np.stack([np.stack([rng.permutation(n) for _ in range(k)])
                   for _ in range(b)]).astype(np.int32)   # some >= num_out
    vals = rng.normal(size=(b, k, n, c)).astype(np.float32)
    got = spread_accumulate(_t(vals), _t(tg), num_out=num_out).numpy()
    np.testing.assert_allclose(got, _numpy_spread(vals, tg, num_out),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        spread_accumulate(_t(vals), _t(tg).long(), num_out=num_out)
    with pytest.raises(ValueError):
        spread_accumulate(_t(vals).double(), _t(tg), num_out=num_out)
    with pytest.raises(ValueError):
        spread_accumulate(_t(vals), _t(tg)[:, :2], num_out=num_out)
    with pytest.raises(ValueError):
        spread_accumulate(_t(vals).transpose(2, 3), _t(tg), num_out=num_out)


# -- output sets and rulebooks ------------------------------------------------

GRID = (6, 12, 10)             # (nz, ny, nx)
SUBM = ((3, 3, 3), (1, 1, 1), (1, 1, 1))
DOWN = ((3, 3, 3), (2, 2, 2), (1, 1, 1))


def _voxel_lists(rng, b, v, grid, counts):
    """(coords (B, V, 3) sorted by cell id with -1 padding, num (B,))."""
    nz, ny, nx = grid
    coords = np.full((b, v, 3), -1, np.int32)
    for i, n in enumerate(counts):
        lins = np.sort(rng.choice(nz * ny * nx, n, replace=False))
        coords[i, :n] = np.stack([lins // (ny * nx), (lins // nx) % ny,
                                  lins % nx], -1)
    return coords, np.asarray(counts, np.int32)


def _low_edge_list(grid, v):
    """Every cell of the grid's low faces (coordinate 0 on some axis),
    as far as the list holds: the taps below the grid are negative."""
    nz, ny, nx = grid
    cells = [(z, y, x) for z in range(nz) for y in range(ny)
             for x in range(nx) if min(z, y, x) == 0][:v]
    coords = np.full((1, v, 3), -1, np.int32)
    coords[0, :len(cells)] = cells
    return coords, np.asarray([len(cells)], np.int32)


@pytest.mark.parametrize("build_fn", ["build_output_coords",
                                     "build_footprint_coords"])
@pytest.mark.parametrize("grid", [GRID, (5, 9, 7)])       # even and odd
def test_output_sets_equal_jax(build_fn, grid):
    rng = np.random.default_rng(grid[0])
    coords, num = _voxel_lists(rng, 3, 64, grid, [50, 64, 0])
    edge_c, edge_n = _low_edge_list(grid, 64)
    coords = np.concatenate([coords, edge_c])
    num = np.concatenate([num, edge_n])
    jspec = jsc.SparseConvSpec(*DOWN, grid)
    pspec = psc.SparseConvSpec(*DOWN, grid)
    assert pspec.grid_out == jspec.grid_out
    np.testing.assert_array_equal(pspec.offsets().numpy(),
                                  np.asarray(jspec.offsets()))
    # A budget that holds every output, and one that overflows (the
    # footprint set is no larger than the input list).
    budgets = (160, 24) if build_fn == "build_output_coords" else (64, 12)
    for max_out in budgets:
        want_c, want_n = jax.vmap(lambda c, n: getattr(jsc, build_fn)(
            c, n, jspec, max_out=max_out))(jnp.asarray(coords),
                                           jnp.asarray(num))
        got_c, got_n = getattr(psc, build_fn)(_t(coords), _t(num), pspec,
                                             max_out=max_out)
        assert got_c.dtype == torch.int32 and got_n.dtype == torch.int32
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        if max_out == budgets[1]:
            assert int(got_n[1]) == max_out       # the budget overflowed


@pytest.mark.parametrize("build_fn", ["build_output_coords",
                                     "build_footprint_coords"])
def test_output_sets_above_the_candidate_count_equal_jax(build_fn):
    """A budget above the number of candidate cells: the JAX functions
    return one row per candidate (``sort(...)[:max_out]``; V rows for the
    footprint set), and so does the port."""
    rng = np.random.default_rng(3)
    coords, num = _voxel_lists(rng, 3, 64, GRID, [50, 64, 0])
    jspec = jsc.SparseConvSpec(*DOWN, GRID)
    pspec = psc.SparseConvSpec(*DOWN, GRID)
    max_out = 10 ** 6
    want_c, want_n = jax.vmap(lambda c, n: getattr(jsc, build_fn)(
        c, n, jspec, max_out=max_out))(jnp.asarray(coords), jnp.asarray(num))
    got_c, got_n = getattr(psc, build_fn)(_t(coords), _t(num), pspec,
                                         max_out=max_out)
    rows = 64 if build_fn == "build_footprint_coords" else 64 * 8
    assert got_c.shape == want_c.shape == (3, rows, 3)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("kind", ["subm", "down", "down_truncated",
                                  "down_footprint"])
def test_rulebooks_equal_jax(kind):
    rng = np.random.default_rng(7)
    coords, num = _voxel_lists(rng, 2, 64, GRID, [50, 37])
    edge_c, edge_n = _low_edge_list(GRID, 64)
    coords = np.concatenate([coords, edge_c])
    num = np.concatenate([num, edge_n])
    geo = SUBM if kind == "subm" else DOWN
    jspec = jsc.SparseConvSpec(*geo, GRID)
    pspec = psc.SparseConvSpec(*geo, GRID)
    if kind == "subm":
        out_c, out_n = coords, num
    else:
        build = (psc.build_footprint_coords if kind == "down_footprint"
                 else psc.build_output_coords)
        oc, on = build(_t(coords), _t(num), pspec, max_out={
            "down": 128, "down_truncated": 20, "down_footprint": 64}[kind])
        out_c, out_n = oc.numpy(), on.numpy()
    want = np.asarray(jsc.build_scatter_rulebook(
        jnp.asarray(coords), jnp.asarray(num), jnp.asarray(out_c),
        jnp.asarray(out_n), jspec))
    got = psc.build_scatter_rulebook(_t(coords), _t(num), _t(out_c),
                                     _t(out_n), pspec)
    assert got.dtype == torch.int32 and got.shape == (3, 27, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 0
    # The gather form, cloud by cloud, and its agreement with the
    # scatter form: out_of[k, i] == o  <=>  rulebook[k, o] == i.
    for i in range(len(num)):
        want_g = np.asarray(jsc.build_rulebook(
            jnp.asarray(coords[i]), jnp.asarray(num[i]),
            jnp.asarray(out_c[i]), jnp.asarray(out_n[i]), jspec))
        got_g = psc.build_rulebook(_t(coords[i]), _t(num[i]), _t(out_c[i]),
                                   _t(out_n[i]), pspec).numpy()
        np.testing.assert_array_equal(got_g, want_g)
        ks, ins = np.nonzero(want[i] >= 0)
        assert (got_g[ks, want[i][ks, ins]] == ins).all()
        assert (got_g >= 0).sum() == len(ks)


# -- the conv and its gradients ----------------------------------------------

@pytest.fixture(scope="module")
def conv_case():
    rng = np.random.default_rng(11)
    b, v, cin, cout = 2, 64, 6, 10
    coords, num = _voxel_lists(rng, b, v, GRID, [50, 37])
    spec = psc.SparseConvSpec(*DOWN, GRID)
    out_c, out_n = psc.build_output_coords(_t(coords), _t(num), spec,
                                           max_out=96)
    srb = psc.build_scatter_rulebook(_t(coords), _t(num), out_c, out_n, spec)
    feats = rng.normal(size=(b, v, cin)).astype(np.float32)
    feats[np.arange(v)[None] >= num[:, None]] = 0.0
    w = (rng.normal(size=(27, cin, cout)) * 0.2).astype(np.float32)
    g = rng.normal(size=(b, 96, cout)).astype(np.float32)
    rulebooks = [psc.build_rulebook(_t(coords[i]), _t(num[i]), out_c[i],
                                    out_n[i], spec) for i in range(b)]
    return feats, w, g, srb, rulebooks


def test_spread_conv_forward_and_gradients(conv_case):
    feats, w, g, srb, rulebooks = conv_case
    v_out = g.shape[1]
    ft, wt = _t(feats).requires_grad_(), _t(w).requires_grad_()
    got = psc.sparse_conv3d_spread(ft, srb, wt, v_out=v_out)
    assert got.dtype == torch.float32
    (got * _t(g)).sum().backward()

    # The gather form under autograd: both are exact f32 products summed
    # in another order: 1e-6 of the largest element.
    fo, wo = _t(feats).requires_grad_(), _t(w).requires_grad_()
    oracle = torch.stack([psc.sparse_conv3d(fo[i], rb, wo)
                          for i, rb in enumerate(rulebooks)])
    (oracle * _t(g)).sum().backward()
    for a, o in ((got, oracle), (ft.grad, fo.grad), (wt.grad, wo.grad)):
        np.testing.assert_allclose(
            a.detach().numpy(), o.detach().numpy(), rtol=0,
            atol=1e-6 * float(o.detach().abs().max()))

    # The JAX custom VJP over the Pallas kernel in interpret mode: its f32
    # streams are routed as two bf16 terms (2^-17 relative per value), in
    # the forward and in both spreads of its backward: 2e-5 of the
    # largest element.
    def f(x, ww):
        return jsc.sparse_conv3d_spread(x, jnp.asarray(srb.numpy()), ww,
                                        v_out=v_out, interpret=True)
    want, vjp = jax.vjp(f, jnp.asarray(feats), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    for a, o in ((got, want), (ft.grad, want_dx), (wt.grad, want_dw)):
        o = np.asarray(o)
        np.testing.assert_allclose(a.detach().numpy(), o, rtol=0,
                                   atol=2e-5 * np.abs(o).max())


def test_spread_conv_bf16_keeps_each_cast(conv_case):
    """bf16 features and weights: the product accumulates in f32, the
    stream is bf16, the kernel adds in f32."""
    feats, w, g, srb, _ = conv_case
    v_out = g.shape[1]
    ft = _t(feats).bfloat16().requires_grad_()
    wt = _t(w).bfloat16().requires_grad_()
    got = psc.sparse_conv3d_spread(ft, srb, wt, v_out=v_out)
    (got * _t(g)).sum().backward()
    assert got.dtype == torch.float32
    assert ft.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.bfloat16

    def f(x, ww):
        return jsc.sparse_conv3d_spread(x, jnp.asarray(srb.numpy()), ww,
                                        v_out=v_out, interpret=True)
    want, vjp = jax.vjp(f, jnp.asarray(feats).astype(jnp.bfloat16),
                        jnp.asarray(w).astype(jnp.bfloat16))
    want_dx, want_dw = vjp(jnp.asarray(g))
    # Each stream value is one bf16 rounding of an f32-accumulated dot
    # product; the two frameworks may accumulate it in another order and
    # round a value to the neighbouring bf16 (2^-8 relative) now and then.
    # The gradients are rounded to bf16 once at the end.
    for a, o in ((got, want), (ft.grad, want_dx), (wt.grad, want_dw)):
        o = np.asarray(o.astype(jnp.float32))
        np.testing.assert_allclose(a.detach().float().numpy(), o, rtol=0,
                                   atol=2.0 ** -7 * np.abs(o).max())
    with pytest.raises(ValueError):
        psc.sparse_conv3d_spread(ft, srb, _t(w), v_out=v_out)
