"""The port's spread-accumulate, output sets, rulebooks and scatter-form sparse
conv against the JAX package's.

Inputs are made with numpy from seeds. The JAX Pallas kernel runs in
interpret mode; the port runs on CPU tensors, where its wrappers compute
their plain versions. Integers (coords, counts, rulebooks) must be equal
exactly.
"""

import os

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


# -- the inverse map handed to the spread -------------------------------------

def _inverse_np(out_of, num_out):
    """The inverse of a scatter rulebook, by hand: [b, k, t] the n with
    out_of[b, k, n] == t, else -1."""
    b, k, _ = out_of.shape
    inv = np.full((b, k, num_out), -1, np.int32)
    bs, ks, ns = np.nonzero((out_of >= 0) & (out_of < num_out))
    inv[bs, ks, out_of[bs, ks, ns]] = ns
    return inv


def _high_edge_list(grid, v):
    """Cells of the grid's high faces, as far as the list holds."""
    nz, ny, nx = grid
    cells = [(z, y, x) for z in range(nz) for y in range(ny)
             for x in range(nx) if z == nz - 1 or y == ny - 1 or x == nx - 1]
    cells = cells[-v:]
    coords = np.full((1, v, 3), -1, np.int32)
    coords[0, :len(cells)] = cells
    return coords, np.asarray([len(cells)], np.int32)


@pytest.mark.parametrize("case", ["random", "low_faces", "high_faces"])
def test_submanifold_sources_invert_the_rulebook_exactly(case):
    """``submanifold_sources`` (the rulebook with k reversed) equals the
    rulebook's inverse built by hand, and the JAX rulebook gives the same
    integers, at grid edges too."""
    rng = np.random.default_rng(13)
    if case == "random":
        coords, num = _voxel_lists(rng, 3, 64, GRID, [50, 37, 0])
    elif case == "low_faces":
        coords, num = _low_edge_list(GRID, 64)
    else:
        coords, num = _high_edge_list(GRID, 64)
    spec = psc.SparseConvSpec(*SUBM, GRID)
    out_of = psc.build_scatter_rulebook(_t(coords), _t(num), _t(coords),
                                        _t(num), spec)
    want_jax = np.asarray(jsc.build_scatter_rulebook(
        jnp.asarray(coords), jnp.asarray(num), jnp.asarray(coords),
        jnp.asarray(num), jsc.SparseConvSpec(*SUBM, GRID)))
    np.testing.assert_array_equal(out_of.numpy(), want_jax)
    got = psc.submanifold_sources(out_of)
    assert got.dtype == torch.int32 and got.is_contiguous()
    inv = _inverse_np(out_of.numpy(), coords.shape[1])
    np.testing.assert_array_equal(got.numpy(), inv)
    np.testing.assert_array_equal(_inverse_np(want_jax, coords.shape[1]),
                                  want_jax[:, ::-1])
    assert (inv >= 0).sum() > num.sum()      # neighbours beyond the centre


def test_encoder_hands_each_submanifold_layer_the_inverse_map():
    """On ``second_tiny``'s first fixture batch: every submanifold layer
    of ``SparseMiddleEncoder`` gets the exact inverse of its rulebook (the
    strided ones none), and the level-0 rulebook equals the JAX one."""
    import lisec_tpu_torch
    from lisec_tpu_torch.data.collate import make_batches
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = lisec_tpu_torch.load_config(
        os.path.join(root, "configs", "second_tiny.yaml"))
    pipe = lisec_tpu_torch.build_model(cfg, device="cpu")
    batch = next(make_batches(pipe.make_dataset("train"), cfg.budget,
                              cfg.train.batch_size, shuffle=False))
    args = pipe._model_args(pipe.device_batch(batch))
    seen = []
    hooks = [layer.register_forward_pre_hook(
        lambda mod, a: seen.append(a[1:])) for layer in
        pipe.model.encoder.sparse]
    pipe.model.eval()
    with torch.no_grad():
        pipe.model(*args)
    for h in hooks:
        h.remove()
    enc = pipe.model.encoder
    per_level = enc.subm_per_level + 1
    assert len(seen) == len(enc.sparse)
    for i, (out_of, valid, *given) in enumerate(seen):
        is_subm = i % per_level < enc.subm_per_level
        assert bool(given) == is_subm
        if is_subm:
            np.testing.assert_array_equal(
                given[0].numpy(), _inverse_np(out_of.numpy(), valid.shape[1]))
    coords, num = args[1].numpy(), args[3].numpy()
    want = np.asarray(jsc.build_scatter_rulebook(
        jnp.asarray(coords), jnp.asarray(num), jnp.asarray(coords),
        jnp.asarray(num), jsc.SparseConvSpec(*SUBM, enc.grid)))
    np.testing.assert_array_equal(seen[0][0].numpy(), want)
    assert (want >= 0).any()


@pytest.mark.parametrize("case,dtype,c", [
    ("collisions", "float32", 16), ("collisions", "bfloat16", 16),
    ("dropped", "bfloat16", 32), ("empty_rows", "float32", 8)])
def test_spread_accumulate_with_sources_equals_without_and_pallas(case,
                                                                  dtype, c):
    rng = np.random.default_rng(len(case) + c + 1)
    b, k, n, num_out = 2, 5, 384, 300
    tg = _streams(rng, b, k, n, num_out, case)
    vals = rng.normal(size=(b, k, n, c)).astype(np.float32)
    tv = _t(vals).to(getattr(torch, dtype))
    sources = _t(_inverse_np(tg, num_out))
    got = spread_accumulate(tv, _t(tg), num_out=num_out, sources=sources)
    assert torch.equal(got, spread_accumulate(tv, _t(tg), num_out=num_out))
    assert torch.equal(got, spread_accumulate_reference(
        tv, _t(tg), num_out=num_out, sources=sources))
    want = _jax_spread(jnp.asarray(vals).astype(dtype), tg, num_out)
    scale = np.abs(want).max()
    tol = 1e-6 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("bad", ["shape", "dtype", "device", "strided"])
def test_spread_accumulate_refuses_a_bad_sources(bad):
    b, k, n, c, num_out = 2, 3, 10, 4, 8
    vals = torch.zeros((b, k, n, c))
    targets = torch.full((b, k, n), -1, dtype=torch.int32)
    sources = torch.full((b, k, num_out), -1, dtype=torch.int32)
    if bad == "shape":
        sources = sources[:, :, :-1].contiguous()
    elif bad == "dtype":
        sources = sources.long()
    elif bad == "device":
        sources = sources.to("meta")
    else:
        sources = sources.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        spread_accumulate(vals, targets, num_out=num_out, sources=sources)


# -- the fused conv's wrapper (``ops/cuda/spread_conv.py``) -------------------

# (kernel, stride, padding) of the fused conv's cases: 3 x 3 x 3 and
# conv_out's 3 x 1 x 1, each submanifold and strided.
FUSED_GEOMETRY = {
    ("subm", 27): SUBM,
    ("down", 27): DOWN,
    ("subm", 3): ((3, 1, 1), (1, 1, 1), (1, 0, 0)),
    ("down", 3): ((3, 1, 1), (2, 1, 1), (0, 0, 0)),
}
FUSED_COUT = {4: 16, 5: 16, 16: 16, 32: 64, 64: 128, 128: 128}


def _fused_case(kind, k, cin, seed=17):
    """A batch of two clouds on ``GRID``: features (B, V, Cin) f32 with
    zero padding rows, weights (K, Cin, Cout), the scatter rulebook, its
    inverse (by hand), the output rows and the gather-form rulebooks."""
    rng = np.random.default_rng(seed + cin + k)
    b, v = 2, 64
    coords, num = _voxel_lists(rng, b, v, GRID, [50, 37])
    spec = psc.SparseConvSpec(*FUSED_GEOMETRY[kind, k], GRID)
    if kind == "subm":
        out_c, out_n = _t(coords), _t(num)
    else:
        out_c, out_n = psc.build_output_coords(_t(coords), _t(num), spec,
                                               max_out=96)
    srb = psc.build_scatter_rulebook(_t(coords), _t(num), out_c, out_n, spec)
    v_out = out_c.shape[1]
    feats = rng.normal(size=(b, v, cin)).astype(np.float32)
    feats[np.arange(v)[None] >= num[:, None]] = 0.0
    w = (rng.normal(size=(k, cin, FUSED_COUT[cin]))
         / np.sqrt(cin)).astype(np.float32)
    gather = [psc.build_rulebook(_t(coords[i]), _t(num[i]), out_c[i],
                                 out_n[i], spec) for i in range(b)]
    sources = _t(_inverse_np(srb.numpy(), v_out))
    assert (srb >= 0).sum() > 0
    return _t(feats), _t(w), srb, sources, v_out, gather


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,k", sorted(FUSED_GEOMETRY))
def test_spread_conv_cpu_route_is_the_pair_bit_for_bit(kind, k, dtype):
    """On a CPU tensor the fused wrapper computes the pair the sparse
    conv ran before it, ``einsum`` then the spread, bit for bit, with
    and without the inverse map; and so does the conv's ``Function``."""
    from lisec_tpu_torch.ops.cuda.spread_conv import spread_conv
    feats, w, srb, sources, v_out, _ = _fused_case(kind, k, 16)
    feats, w = feats.to(getattr(torch, dtype)), w.to(getattr(torch, dtype))
    z = torch.einsum("bvc,kcd->bkvd", feats, w)
    pair = spread_accumulate(z.contiguous(), srb, num_out=v_out)
    for given in (None, sources):
        got = spread_conv(feats, w, srb, num_out=v_out, sources=given)
        assert got.dtype == torch.float32
        assert got.shape == (2, v_out, w.shape[2])
        assert torch.equal(got, pair)
        assert torch.equal(psc.sparse_conv3d_spread(
            feats, srb, w, v_out=v_out, sources=given), pair)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin", sorted(FUSED_COUT))
@pytest.mark.parametrize("kind,k", sorted(FUSED_GEOMETRY))
def test_spread_conv_plain_version_equals_the_gather_oracle(kind, k, cin,
                                                            dtype):
    """The fused kernel's plain version against the gather form, cloud by
    cloud, with and without the inverse map: in bf16 each tap's product
    is rounded once and the oracle's sum once, 2^-7 of the largest
    element; in f32 the two sum exact products in other orders, 2e-5."""
    from lisec_tpu_torch.ops.cuda.spread_conv import (
        spread_conv, spread_conv_reference)
    feats, w, srb, sources, v_out, gather = _fused_case(kind, k, cin)
    feats, w = feats.to(getattr(torch, dtype)), w.to(getattr(torch, dtype))
    oracle = torch.stack([psc.sparse_conv3d(feats[i], rb, w).float()
                          for i, rb in enumerate(gather)])
    tol = (2.0 ** -7 if dtype == "bfloat16" else 2e-5) * float(
        oracle.abs().max())
    assert float(oracle.abs().max()) > 0
    for given in (None, sources):
        got = spread_conv_reference(feats, w, srb, num_out=v_out,
                                    sources=given)
        assert torch.equal(got, spread_conv(feats, w, srb, num_out=v_out,
                                            sources=given))
        np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("bad", [
    "features_dtype", "mixed_dtypes", "weights_cin", "features_rank",
    "targets_dtype", "targets_shape", "features_strided", "weights_strided",
    "targets_strided", "sources_shape", "sources_dtype", "sources_strided",
    "sources_device", "cin_too_wide", "cout_too_wide", "too_many_taps"])
def test_spread_conv_refuses_what_the_kernel_does_not_take(bad):
    from lisec_tpu_torch.ops.cuda.spread_conv import spread_conv
    b, v, cin, k, cout, num_out = 2, 10, 8, 3, 16, 8
    feats = torch.zeros((b, v, cin))
    w = torch.zeros((k, cin, cout))
    targets = torch.full((b, k, v), -1, dtype=torch.int32)
    sources = None
    if bad == "features_dtype":
        feats = feats.double()
    elif bad == "mixed_dtypes":
        feats = feats.bfloat16()
    elif bad == "weights_cin":
        w = torch.zeros((k, cin + 1, cout))
    elif bad == "features_rank":
        feats = feats[None]
    elif bad == "targets_dtype":
        targets = targets.long()
    elif bad == "targets_shape":
        targets = targets[:, :, :-1].contiguous()
    elif bad == "features_strided":
        feats = torch.zeros((b, cin, v)).transpose(1, 2)
    elif bad == "weights_strided":
        w = torch.zeros((k, cout, cin)).transpose(1, 2)
    elif bad == "targets_strided":
        targets = torch.full((b, v, k), -1, dtype=torch.int32).transpose(1, 2)
    elif bad.startswith("sources"):
        sources = torch.full((b, k, num_out), -1, dtype=torch.int32)
        if bad == "sources_shape":
            sources = sources[:, :, :-1].contiguous()
        elif bad == "sources_dtype":
            sources = sources.long()
        elif bad == "sources_strided":
            sources = torch.full((b, num_out, k), -1,
                                 dtype=torch.int32).transpose(1, 2)
        else:
            sources = sources.to("meta")
    elif bad == "cin_too_wide":
        feats, w = torch.zeros((b, v, 129)), torch.zeros((k, 129, cout))
    elif bad == "cout_too_wide":
        w = torch.zeros((k, cin, 129))
    else:
        w = torch.zeros((65, cin, cout))
        targets = torch.full((b, 65, v), -1, dtype=torch.int32)
    with pytest.raises(ValueError):
        spread_conv(feats, w, targets, num_out=num_out, sources=sources)


def test_skipped_share_counts_the_tiles_an_offset_names_no_row_of():
    from lisec_tpu_torch.ops.cuda.spread_conv import TILE_ROWS, skipped_share
    # 2 clouds, 3 offsets, two tiles and a ragged third: 18 pairs.
    in_of = torch.full((2, 3, 2 * TILE_ROWS + 5), -1, dtype=torch.int32)
    in_of[0, 0, 3] = 7                                # tile 0
    in_of[0, 2, 2 * TILE_ROWS + 4] = 1                # the ragged tile
    in_of[1, 1, TILE_ROWS:2 * TILE_ROWS] = 0          # all of tile 1
    assert skipped_share(in_of) == pytest.approx(15 / 18)
    assert skipped_share(torch.zeros((1, 2, 3), dtype=torch.int32)) == 0.0
