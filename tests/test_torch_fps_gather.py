"""The port's farthest-point sampling, row gather and ordered row scatter,
ball query, 3-NN and grouping against the JAX package's.

Inputs are made with numpy from seeds. The JAX Pallas kernels run in
interpret mode and the XLA functions on the CPU; the port runs on CPU
tensors, where its wrappers compute their plain versions. Integers (FPS
picks, ball-query and 3-NN indices) must be equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lisec_tpu.ops.ball_query import ball_query as jax_ball_query
from lisec_tpu.ops.fps import farthest_point_sampling as jax_fps
from lisec_tpu.ops.grouping import group_and_decorate as jax_group
from lisec_tpu.ops.pallas.fps_kernel import fps_pallas
from lisec_tpu.ops.pallas.gather_mxu import (
    gather_rows as jax_gather_rows, gather_rows_mxu, scatter_rows_mxu)
from lisec_tpu.ops.three_nn import (
    three_interpolate as jax_three_interpolate, three_nn as jax_three_nn)
from lisec_tpu_torch.ops.ball_query import ball_query
from lisec_tpu_torch.ops.cuda import fps as fps_mod
from lisec_tpu_torch.ops.cuda import gather_rows as gr
from lisec_tpu_torch.ops.fps import farthest_point_sampling
from lisec_tpu_torch.ops.grouping import group_and_decorate
from lisec_tpu_torch.ops.three_nn import three_interpolate, three_nn
from tests.oracles import ops_np

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- farthest-point sampling ------------------------------------------------

def _fps_case(case):
    """(points (B, N, 3) f32, mask (B, N), M) for one named case."""
    rng = np.random.default_rng(len(case))
    b, n, m = 3, 203, 48                  # N no multiple of any block size
    pts = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    mask = rng.random((b, n)) > 0.15
    if case == "all_masked":
        mask[1] = False
    elif case == "fewer_valid_than_m":
        mask[0] = False
        mask[0, rng.choice(n, 20, replace=False)] = True
    elif case == "masked_middle":
        mask[:] = True
        mask[:, 60:140] = False
    elif case == "ties":
        # Coordinates on a coarse integer grid and repeated points: many
        # distances are equal, so the lowest index must win each argmax.
        pts = rng.integers(-2, 3, (b, n, 3)).astype(np.float32)
        pts[:, 100:150] = pts[:, 10:60]
    elif case == "batch_one":
        pts, mask = pts[:1], mask[:1]
    elif case == "m_equals_n":
        pts, mask, m = pts[:, :64], mask[:, :64], 64
    return pts, mask, m


FPS_CASES = ["random", "all_masked", "fewer_valid_than_m", "masked_middle",
             "ties", "batch_one", "m_equals_n"]


@pytest.mark.parametrize("case", FPS_CASES)
def test_fps_equals_pallas_xla_and_numpy(case):
    pts, mask, m = _fps_case(case)
    got = farthest_point_sampling(_t(pts), _t(mask), m)
    assert got.dtype == torch.int32 and got.shape == (len(pts), m)
    got = got.numpy()
    pallas = np.asarray(fps_pallas(jnp.asarray(pts), jnp.asarray(mask), m,
                                   interpret=True))
    xla = np.asarray(jax_fps(jnp.asarray(pts), jnp.asarray(mask), m,
                             use_pallas=False))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    for b in range(len(pts)):
        np.testing.assert_array_equal(got[b],
                                      ops_np.fps_np(pts[b], mask[b], m))
        if mask[b].any():
            assert mask[b][got[b]].all()            # never a masked point
        else:
            assert not got[b].any()                 # all zeros
    if case == "fewer_valid_than_m":
        assert len(set(got[0].tolist())) == 20


@pytest.mark.parametrize("case", FPS_CASES)
def test_fps_gather_equals_pallas_picks_and_their_rows(case):
    """``fps_gather``: the picks of JAX ``fps_pallas`` and, bit for bit,
    the picked points' xyz and mask (``take_along_axis`` of the picks)."""
    pts, mask, m = _fps_case(case)
    idx, new_xyz, new_mask = fps_mod.fps_gather(_t(pts), _t(mask), m)
    assert idx.dtype == torch.int32 and idx.shape == (len(pts), m)
    assert new_xyz.dtype == torch.float32 and new_xyz.shape == (len(pts), m,
                                                                 3)
    assert new_mask.dtype == torch.bool and new_mask.shape == (len(pts), m)
    pallas = np.asarray(fps_pallas(jnp.asarray(pts), jnp.asarray(mask), m,
                                   interpret=True))
    np.testing.assert_array_equal(idx.numpy(), pallas)
    want_xyz = np.take_along_axis(pts, pallas[..., None].astype(np.int64),
                                  axis=1)
    np.testing.assert_array_equal(new_xyz.numpy().view(np.int32),
                                  want_xyz.view(np.int32))
    np.testing.assert_array_equal(new_mask.numpy(),
                                  np.take_along_axis(mask, pallas, axis=1))


def test_fps_gather_refuses_points_that_require_grad():
    pts, mask, m = _fps_case("random")
    p = _t(pts).requires_grad_()
    with pytest.raises(ValueError, match="gradient"):
        fps_mod.fps_gather(p, _t(mask), m)
    for bad in (lambda: fps_mod.fps_gather(_t(pts), _t(mask).int(), m),
                lambda: fps_mod.fps_gather(_t(pts), _t(mask), 0)):
        with pytest.raises(ValueError):
            bad()


def test_fps_takes_leading_dims_and_refuses_what_the_kernel_cannot():
    pts, mask, m = _fps_case("random")
    four = np.stack([pts, pts[::-1]])                # (2, 3, N, 3)
    got = farthest_point_sampling(_t(four), _t(np.stack([mask, mask[::-1]])),
                                  m)
    assert got.shape == (2, 3, m)
    np.testing.assert_array_equal(got[1].numpy(),
                                  got[0].numpy()[::-1])
    p, k = _t(pts), _t(mask)
    for bad in (lambda: fps_mod.fps(p.double(), k, m),
                lambda: fps_mod.fps(p, k.int(), m),
                lambda: fps_mod.fps(p[:, :, :2].contiguous(), k, m),
                lambda: fps_mod.fps(p.transpose(0, 1).contiguous()
                                    .transpose(0, 1), k, m),
                lambda: fps_mod.fps(p, k, 0),
                lambda: fps_mod.fps(torch.zeros((1, fps_mod.MAX_POINTS + 1,
                                                 3)),
                                    torch.ones((1, fps_mod.MAX_POINTS + 1),
                                               dtype=torch.bool), 4)):
        with pytest.raises(ValueError):
            bad()


# -- the row gather ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [1, 3, 8, 20])
def test_gather_equals_pallas_and_take_along_axis(dtype, c):
    rng = np.random.default_rng(c)
    b, n, m = 2, 96, 333                   # M no multiple of the tile
    src = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(-3, n + 3, (b, m)).astype(np.int32)   # -1.., >= N
    idx[0, :5] = [-1, n, n + 7, 0, n - 1]
    jsrc = jnp.asarray(src, dtype)
    tsrc = _t(np.asarray(jsrc.astype(jnp.float32))).to(getattr(torch, dtype))
    got = gr.gather_rows(tsrc, _t(idx))
    assert got.dtype == tsrc.dtype and got.shape == (b, m, c)
    got = got.float().numpy()
    ok = (idx >= 0) & (idx < n)
    assert not got[~ok].any()                       # zero rows
    # Against take_along_axis on the in-range ids: exact.
    want = np.take_along_axis(np.asarray(jsrc.astype(jnp.float32)),
                              np.where(ok, idx, 0)[..., None], axis=1)
    np.testing.assert_array_equal(got, np.where(ok[..., None], want, 0))
    # Against the Pallas kernel: bf16 routes exactly in one product; f32
    # goes through two bf16 terms there (2^-17 relative), so 2e-5.
    pallas = np.asarray(gather_rows_mxu(jsrc, jnp.asarray(idx), tile_m=128,
                                        interpret=True).astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, pallas)
    else:
        np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=1e-30)


# -- the ordered row scatter ------------------------------------------------

def _scatter_np(vals, idx, num_rows):
    out = np.zeros((vals.shape[0], num_rows, vals.shape[2]), np.float32)
    for b in range(vals.shape[0]):
        for m, i in enumerate(idx[b]):
            if 0 <= i < num_rows:
                out[b, i] += vals[b, m]
    return out


def _scatter_ids(case, rng, b, m, num_rows):
    if case == "duplicates":               # ball-query style repeat-fill
        idx = rng.integers(0, num_rows, (b, m // 8)).repeat(8, axis=1)
        idx[:, ::5] = rng.integers(-2, num_rows + 2, (b, len(idx[0, ::5])))
    elif case == "one_target":
        idx = np.full((b, m), num_rows - 1)
    elif case == "all_dropped":
        idx = np.where(rng.random((b, m)) < 0.5, -1, num_rows + 3)
    else:                                  # descending
        idx = np.sort(rng.integers(0, num_rows, (b, m)), axis=1)[:, ::-1]
    return np.ascontiguousarray(idx).astype(np.int32)


@pytest.mark.parametrize("case", ["duplicates", "one_target", "all_dropped",
                                  "descending"])
def test_scatter_equals_pallas_and_numpy(case):
    rng = np.random.default_rng(len(case))
    b, m, c, num_rows = 2, 320, 12, 40
    vals = rng.normal(size=(b, m, c)).astype(np.float32)
    idx = _scatter_ids(case, rng, b, m, num_rows)
    got = gr.scatter_rows(_t(vals), _t(idx), num_rows=num_rows)
    assert got.dtype == torch.float32 and got.shape == (b, num_rows, c)
    got = got.numpy()
    # f32 sums in m order here; the Pallas kernel sums a tile's rows in a
    # product (two bf16 terms, 2^-17) and the numpy loop in m order:
    # 2e-4 of the largest sum.
    scale = max(np.abs(got).max(), 1.0)
    want = np.asarray(scatter_rows_mxu(jnp.asarray(vals), jnp.asarray(idx),
                                       num_rows=num_rows, tile_m=128,
                                       interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * scale)
    np.testing.assert_allclose(got, _scatter_np(vals, idx, num_rows),
                               rtol=0, atol=2e-4 * scale)
    if case == "all_dropped":
        assert not got.any()
    if case == "one_target":
        assert not got[:, :-1].any()


def _scatter_edge(case, rng):
    """(vals, idx, num_rows) at the edges of the kernel's tiling: tables of
    no multiple of a tile, one id, one target with more rows than the
    kernel's 2048-id chunk, ids dropped beyond both ends."""
    if case == "rows33":
        b, m, c, r = 2, 300, 5, 33
        idx = rng.integers(-3, r + 3, (b, m))
    elif case == "rows1000":
        b, m, c, r = 2, 1500, 4, 1000
        idx = rng.integers(-3, r + 3, (b, m))
    elif case == "m1":
        b, m, c, r = 3, 1, 3, 3
        idx = np.array([[0], [2], [-1]])
    elif case == "one_target_over_a_chunk":
        b, m, c, r = 1, 2600, 4, 40
        idx = rng.integers(0, r, (b, m))
        idx[0, rng.choice(m, 2200, replace=False)] = 17
    else:                                  # dropped_both_sides
        b, m, c, r = 2, 400, 8, 50
        idx = np.where(rng.random((b, m)) < 0.5,
                       rng.integers(-40, 0, (b, m)),
                       rng.integers(r, r + 40, (b, m)))
        idx[:, ::7] = rng.integers(0, r, (b, len(idx[0, ::7])))
    vals = rng.normal(size=(b, m, c)).astype(np.float32)
    return vals, np.ascontiguousarray(idx).astype(np.int32), r


@pytest.mark.parametrize("case", ["rows33", "rows1000", "m1",
                                  "one_target_over_a_chunk",
                                  "dropped_both_sides"])
def test_scatter_tiling_edges_equal_pallas_and_numpy(case):
    rng = np.random.default_rng(len(case) + 50)
    vals, idx, num_rows = _scatter_edge(case, rng)
    got = gr.scatter_rows(_t(vals), _t(idx), num_rows=num_rows).numpy()
    # The numpy loop adds in f32 in m order, as the kernel does: equal to
    # the bit. The Pallas kernel's two bf16 terms: 2e-4 of the largest sum.
    np.testing.assert_array_equal(got, _scatter_np(vals, idx, num_rows))
    scale = max(np.abs(got).max(), 1.0)
    want = np.asarray(scatter_rows_mxu(jnp.asarray(vals), jnp.asarray(idx),
                                       num_rows=num_rows, tile_m=128,
                                       interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * scale)
    landed = np.zeros(num_rows, bool)
    landed[idx[(idx >= 0) & (idx < num_rows)]] = True
    assert not got[:, ~landed].any()


def test_scatter_plain_version_adds_in_m_order():
    """Equal ids are summed in m order, as the kernel's owner thread adds
    them: against a float32 loop in that order, bit for bit."""
    rng = np.random.default_rng(9)
    vals = (rng.normal(size=(1, 64, 3)) * 10.0 ** rng.integers(
        -4, 5, (1, 64, 1))).astype(np.float32)
    idx = rng.integers(0, 3, (1, 64)).astype(np.int32)
    got = gr.scatter_rows(_t(vals), _t(idx), num_rows=3).numpy()
    want = np.zeros((1, 3, 3), np.float32)
    for mm in range(64):
        want[0, idx[0, mm]] = want[0, idx[0, mm]] + vals[0, mm]
    np.testing.assert_array_equal(got, want)


def test_gather_rows_gradient_equals_jax_custom_vjp():
    rng = np.random.default_rng(4)
    b, n, c, m = 2, 50, 6, 200
    src = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(-1, n, (b, m)).astype(np.int32)
    w = rng.normal(size=(b, m, c)).astype(np.float32)
    want = np.asarray(jax.grad(lambda s: jnp.sum(jax_gather_rows(
        s, jnp.asarray(idx), True) * w))(jnp.asarray(src)))
    s = _t(src).requires_grad_()
    (gr.GatherRows.apply(s, _t(idx)) * _t(w)).sum().backward()
    # The JAX scatter routes f32 as two bf16 terms (2^-17 relative per
    # term, a few terms per row): 2e-5 of the largest element. Against
    # XLA's own gather gradient (an exact scatter-add in another order):
    # 1e-6.
    got = s.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    ok = (idx >= 0)[..., None]
    exact = np.asarray(jax.grad(lambda t: jnp.sum(jnp.take_along_axis(
        t, jnp.asarray(np.maximum(idx, 0))[..., None], axis=1)
        * jnp.where(ok, w, 0)))(jnp.asarray(src)))
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-6)
    # A source with no gradient takes no backward scatter.
    before = gr.SCATTER_LAUNCHES
    plain = torch.ones((b, n, c), requires_grad=False)
    out = gr.GatherRows.apply(plain, _t(idx))
    assert not out.requires_grad and gr.SCATTER_LAUNCHES == before
    # bf16 sources take a bf16 gradient, as ``_gather_bwd`` casts it.
    sb = _t(src).bfloat16().requires_grad_()
    gr.GatherRows.apply(sb, _t(idx)).float().sum().backward()
    assert sb.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("bad", ["dtype", "ids", "batch", "strided",
                                 "empty", "rows"])
def test_row_wrappers_refuse_what_the_kernels_cannot(bad):
    src = torch.zeros((2, 5, 4))
    idx = torch.zeros((2, 3), dtype=torch.int32)
    if bad == "dtype":
        src = src.double()
    elif bad == "ids":
        idx = idx.long()
    elif bad == "batch":
        idx = idx[:1]
    elif bad == "strided":
        src = src.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "empty":
        idx = idx[:, :0]
    with pytest.raises(ValueError):
        if bad == "rows":
            gr.scatter_rows(torch.zeros((2, 3, 4)), idx, num_rows=0)
        else:
            gr.gather_rows(src, idx)


@pytest.mark.parametrize("bad", ["dtype", "ids", "batch", "strided",
                                 "empty", "length"])
def test_scatter_wrapper_refuses_what_the_kernel_cannot(bad):
    vals = torch.zeros((2, 3, 4))
    idx = torch.zeros((2, 3), dtype=torch.int32)
    if bad == "dtype":
        vals = vals.half()
    elif bad == "ids":
        idx = idx.long()
    elif bad == "batch":
        idx = idx[:1]
    elif bad == "strided":
        vals = vals.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "empty":
        vals, idx = vals[:, :0], idx[:, :0]
    elif bad == "length":                  # one id per row of vals
        idx = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        gr.scatter_rows(vals, idx, num_rows=5)


# -- ball query, 3-NN, grouping ---------------------------------------------

@pytest.mark.parametrize("radius", [0.15, 0.4, 2.0])
def test_ball_query_equals_jax_and_numpy(radius):
    rng = np.random.default_rng(int(radius * 100))
    b, n, m, k = 2, 300, 40, 16
    pts = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    mask = rng.random((b, n)) > 0.2
    centers = pts[:, :m].copy()
    centers[:, 0] = 5.0                    # a centre with no neighbour
    got = ball_query(_t(centers), _t(pts), _t(mask), radius=radius,
                     num_neighbors=k)
    assert got.dtype == torch.int32 and got.shape == (b, m, k)
    want = np.asarray(jax_ball_query(
        jnp.asarray(centers), jnp.asarray(pts), jnp.asarray(mask),
        radius=radius, num_neighbors=k, force_approx=False))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[:, 0].any()
    for i in range(b):
        np.testing.assert_array_equal(
            got[i].numpy(),
            ops_np.ball_query_np(centers[i], pts[i], mask[i], radius, k))


def test_three_nn_and_interpolate_equal_jax():
    rng = np.random.default_rng(5)
    b, n, s, c = 2, 120, 40, 7
    query = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    source = rng.uniform(-1, 1, (b, s, 3)).astype(np.float32)
    source[:, 20:25] = source[:, 5:10]     # equal distances: lower first
    query[:, :5] = source[:, 5:10]         # and zero distances
    mask = rng.random((b, s)) > 0.2
    mask[1, 3:] = False                    # fewer than 3 valid sources
    feats = rng.normal(size=(b, s, c)).astype(np.float32)
    d2, idx = three_nn(_t(query), _t(source), _t(mask))
    jd2, jidx = jax_three_nn(jnp.asarray(query), jnp.asarray(source),
                             jnp.asarray(mask))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-6,
                               atol=1e-6)
    got = three_interpolate(_t(feats), idx, d2).numpy()
    want = np.asarray(jax_three_interpolate(jnp.asarray(feats), jidx, jd2))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_group_and_decorate_equals_jax():
    rng = np.random.default_rng(6)
    b, n, m, k, c = 2, 64, 10, 8, 5
    xyz = rng.normal(size=(b, n, 3)).astype(np.float32)
    feats = rng.normal(size=(b, n, c)).astype(np.float32)
    centers = xyz[:, :m]
    idx = rng.integers(0, n, (b, m, k)).astype(np.int32)
    for f in (feats, None):
        got = group_and_decorate(_t(xyz), None if f is None else _t(f),
                                 _t(centers), _t(idx)).numpy()
        want = np.asarray(jax_group(
            jnp.asarray(xyz), None if f is None else jnp.asarray(f),
            jnp.asarray(centers), jnp.asarray(idx)))
        assert got.shape == (b, m, k, 3 + (0 if f is None else c))
        np.testing.assert_array_equal(got, want)


def _jax_group_zero_rows(xyz, feats, centers, idx):
    """JAX ``group_and_decorate`` with ids outside [0, N) reading zero
    rows, the gather kernels' rule: a zero row appended to each source
    and those ids pointed at it (XLA's own gather would fill NaN)."""
    n = xyz.shape[1]
    pad = ((0, 0), (0, 1), (0, 0))
    safe = np.where((idx >= 0) & (idx < n), idx, n)
    return jax_group(jnp.asarray(np.pad(xyz, pad)),
                     None if feats is None else jnp.asarray(np.pad(feats,
                                                                   pad)),
                     jnp.asarray(centers), jnp.asarray(safe))


@pytest.mark.parametrize("features", [True, False])
@pytest.mark.parametrize("ids", ["in_range", "beyond_both_ends"])
def test_fused_grouping_equals_jax_and_its_vjp(features, ids):
    """The grouping wrapper (one launch on the card) and its
    ``autograd.Function`` against JAX ``group_and_decorate``: the
    coordinates to 1e-6 relative (the same f32 subtraction: exact in
    practice), the features exact (a copy); the gradients of features,
    xyz and centres against the JAX VJP to 1e-6 of the largest (the same
    f32 sums in another order)."""
    rng = np.random.default_rng(7 + features + 2 * (ids == "in_range"))
    b, n, m, k, c = 2, 64, 10, 8, 5
    xyz = rng.normal(size=(b, n, 3)).astype(np.float32)
    feats = rng.normal(size=(b, n, c)).astype(np.float32) if features \
        else None
    centers = rng.normal(size=(b, m, 3)).astype(np.float32)
    lo, hi = (0, n) if ids == "in_range" else (-3, n + 3)
    idx = rng.integers(lo, hi, (b, m, k)).astype(np.int32)
    if ids != "in_range":
        idx[0, 0, :3] = [-1, n, n - 1]
    want = np.asarray(_jax_group_zero_rows(xyz, feats, centers, idx))
    got = gr.group_and_decorate(_t(xyz), None if feats is None else _t(feats),
                                _t(centers), _t(idx)).numpy()
    assert got.shape == (b, m, k, 3 + (c if features else 0))
    np.testing.assert_allclose(got[..., :3], want[..., :3], rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(got[..., 3:], want[..., 3:])
    if ids == "in_range":                    # XLA's own gather: exact
        np.testing.assert_array_equal(got, np.asarray(jax_group(
            jnp.asarray(xyz), None if feats is None else jnp.asarray(feats),
            jnp.asarray(centers), jnp.asarray(idx))))

    g = rng.normal(size=got.shape).astype(np.float32)
    args = [jnp.asarray(xyz), jnp.asarray(centers)]
    if features:
        args.append(jnp.asarray(feats))

    def f(x, ctr, *ft):
        n_ = x.shape[1]
        pad = ((0, 0), (0, 1), (0, 0))
        safe = np.where((idx >= 0) & (idx < n_), idx, n_)
        return jax_group(jnp.pad(x, pad), jnp.pad(ft[0], pad) if ft
                         else None, ctr, jnp.asarray(safe))
    _, vjp = jax.vjp(f, *args)
    want_grads = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    tx, tc = _t(xyz).requires_grad_(), _t(centers).requires_grad_()
    tf = _t(feats).requires_grad_() if features else None
    from lisec_tpu_torch.ops import grouping
    out = grouping.group_and_decorate(tx, tf, tc, _t(idx))
    (out * _t(g)).sum().backward()
    got_grads = [tx.grad, tc.grad] + ([tf.grad] if features else [])
    for name, a, w in zip(("xyz", "centers", "features"), got_grads,
                          want_grads):
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)
    # Where only the features need a gradient, only they get one.
    if features:
        tf2 = _t(feats).requires_grad_()
        grouping.group_and_decorate(_t(xyz), tf2, _t(centers),
                                    _t(idx)).sum().backward()
        np.testing.assert_allclose(tf2.grad.numpy(), np.asarray(vjp(
            jnp.ones_like(jnp.asarray(g)))[2]), rtol=0, atol=1e-5)


def test_fused_grouping_takes_leading_dims():
    rng = np.random.default_rng(8)
    xyz = rng.normal(size=(2, 3, 40, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 3, 40, 4)).astype(np.float32)
    centers = xyz[:, :, :6]
    idx = rng.integers(0, 40, (2, 3, 6, 5)).astype(np.int32)
    got = group_and_decorate(_t(xyz), _t(feats), _t(centers), _t(idx))
    want = np.asarray(jax_group(jnp.asarray(xyz), jnp.asarray(feats),
                                jnp.asarray(centers), jnp.asarray(idx)))
    assert got.shape == (2, 3, 6, 5, 7)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", ["xyz_dtype", "features_dtype", "ids",
                                 "batch", "features_rows", "strided",
                                 "empty", "xyz_width"])
def test_grouping_wrapper_refuses_what_the_kernel_cannot(bad):
    xyz = torch.zeros((2, 5, 3))
    feats = torch.zeros((2, 5, 4))
    centers = torch.zeros((2, 3, 3))
    idx = torch.zeros((2, 3, 2), dtype=torch.int32)
    if bad == "xyz_dtype":
        xyz = xyz.double()
    elif bad == "features_dtype":
        feats = feats.bfloat16()
    elif bad == "ids":
        idx = idx.long()
    elif bad == "batch":
        centers, idx = centers[:1], idx[:1]
    elif bad == "features_rows":
        feats = torch.zeros((2, 6, 4))
    elif bad == "strided":
        feats = feats.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "empty":
        idx = idx[:, :, :0]
    elif bad == "xyz_width":
        xyz = torch.zeros((2, 5, 4))
    with pytest.raises(ValueError):
        gr.group_and_decorate(xyz, feats, centers, idx)
