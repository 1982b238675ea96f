"""The port's fused pillar encoder against the JAX package's.

The port's plain version (``pillar_canvas_fused_reference``, which its
wrapper runs for CPU tensors) is held against the Pallas kernel in
interpret mode, and the port's encoder module against the JAX module's
scatter-based reference path, on the same numpy inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lisec_tpu.models.pillar_encoder import (
    FusedPillarEncoder as JaxEncoder)
from lisec_tpu.ops.pallas.encoder_kernel import (
    pillar_canvas_fused as jax_canvas)
from lisec_tpu_torch.models.pillar_encoder import FusedPillarEncoder
from lisec_tpu_torch.ops.cuda import encoder_kernel as ek

torch.set_num_threads(1)

GEO = dict(grid=(64, 64), pc_range=(0.0, -20.48, -3.0, 10.24, 20.48, 1.0),
           voxel_size=(0.16, 0.64))
B, N, C = 2, 2048, 64


def _big(w, t, r):
    """The JAX kernel's per-channel shift BIG (encoder_kernel.py:362-367);
    its hi/lo bf16 routing of u + BIG is exact to about BIG * 2^-16."""
    weff = np.stack([w[0] + w[4] + w[7], w[1] + w[5] + w[8], w[2] + w[6],
                     w[3]])
    coord_max = np.array([max(abs(r[0]), abs(r[3])),
                          max(abs(r[1]), abs(r[4])),
                          max(abs(r[2]), abs(r[5])), 1.0], np.float32)
    return (np.abs(weff).T @ coord_max + np.abs(w[7]) * coord_max[0]
            + np.abs(w[8]) * coord_max[1] + np.abs(t) + 1.0)


def _in_cells(rng, cells):
    """x, y at random spots inside the given cells (ids iy * nx + ix)."""
    r, (vx, vy), (nx, _) = GEO["pc_range"], GEO["voxel_size"], GEO["grid"]
    jitter = rng.uniform(0.1, 0.9, cells.shape + (2,))
    x = r[0] + (cells % nx + jitter[..., 0]) * vx
    y = r[1] + (cells // nx + jitter[..., 1]) * vy
    return x.astype(np.float32), y.astype(np.float32)


def _cloud(case, rng):
    # dense_tile needs more points than the canvas kernel sorts at once.
    n = ek.KEYS_PER_PASS + 64 if case == "dense_tile" else N
    pts = rng.uniform([-1, -25, -4, 0], [12, 25, 2, 1],
                      (B, n, 4)).astype(np.float32)
    mask = rng.random((B, n)) > 0.1
    r, (vx, vy), (nx, ny) = GEO["pc_range"], GEO["voxel_size"], GEO["grid"]
    tile = ek.TILE_CELLS
    if case == "all_invalid":
        mask[:] = False
    elif case == "one_cell":
        pts[..., 0] = np.float32(r[0] + 17.5 * vx)
        pts[..., 1] = np.float32(r[1] + 40.5 * vy)
        pts[..., 2] = rng.uniform(-2.5, 0.5, (B, N))
        mask[:] = True
    elif case == "cell_edges":
        ix = rng.integers(0, nx + 1, (B, N)).astype(np.float32)
        iy = rng.integers(0, ny + 1, (B, N)).astype(np.float32)
        pts[..., 0] = ix * np.float32(vx) + np.float32(r[0])
        pts[..., 1] = iy * np.float32(vy) + np.float32(r[1])
    elif case == "dense_tile":
        # Cloud 0: every point in the cells of the second tile, a third of
        # them in one cell; cloud 1: every point in one cell of the first.
        cells = tile + rng.integers(0, tile, n)
        cells[: n // 3] = tile + 77
        pts[0, :, 0], pts[0, :, 1] = _in_cells(rng, cells)
        pts[1, :, 0], pts[1, :, 1] = _in_cells(rng, np.full(n, 1000))
        pts[..., 2] = rng.uniform(-2.5, 0.5, (B, n))
        mask[:] = True
    elif case == "tile_boundary":
        # Half the points in the last cell of a tile, the first of the
        # next and the grid's last cell; the rest at random.
        edge = np.array([tile - 1, tile, nx * ny - 1])
        cells = edge[rng.integers(0, 3, (B, N // 2))]
        pts[:, : N // 2, 0], pts[:, : N // 2, 1] = _in_cells(rng, cells)
        pts[:, : N // 2, 2] = rng.uniform(-2.5, 0.5, (B, N // 2))
        mask[:, : N // 2] = True
    return pts, mask


def _weights(rng):
    w = (rng.normal(size=(9, C)) * 0.3).astype(np.float32)
    t = (rng.normal(size=C) * 0.1).astype(np.float32)
    return w, t


@pytest.mark.parametrize("case",
                         ["random", "all_invalid", "one_cell", "cell_edges",
                          "dense_tile", "tile_boundary"])
def test_plain_matches_pallas_kernel(case):
    rng = np.random.default_rng(1)
    pts, mask = _cloud(case, rng)
    w, t = _weights(rng)
    want = np.asarray(jax_canvas(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(w), jnp.asarray(t),
        out_dtype=jnp.float32, interpret=True, **GEO))
    got = ek.pillar_canvas_fused(
        torch.from_numpy(pts), torch.from_numpy(mask), torch.from_numpy(w),
        torch.from_numpy(t), out_dtype=torch.float32, **GEO).numpy()
    assert got.shape == want.shape == (B, 64 * 64, C)

    # Cell ids: the port's glue against the JAX module's _cells as its
    # jitted programs run it, exactly.
    cells_fn = jax.jit(JaxEncoder(num_filters=C, **GEO)._cells)
    jax_cell = np.asarray(cells_fn(jnp.asarray(pts), jnp.asarray(mask))[0])
    cell = ek.pillar_cells(torch.from_numpy(pts), torch.from_numpy(mask),
                           **GEO)[0].numpy()
    np.testing.assert_array_equal(cell, jax_cell)

    # Non-empty pattern: exactly the same cells, all of them occupied.
    nonempty = (got != 0).any(-1)
    np.testing.assert_array_equal(nonempty, (want != 0).any(-1))
    occupied = np.stack([np.bincount(c, minlength=64 * 64 + 1)[:-1] > 0
                         for c in cell])
    assert not (nonempty & ~occupied).any()
    if case == "all_invalid":
        assert not nonempty.any()
    if case == "one_cell":
        assert occupied.sum(-1).tolist() == [1, 1]
    if case == "dense_tile":
        tile = ek.TILE_CELLS
        assert not occupied[0, :tile].any() and not occupied[:, 2 * tile:].any()
        assert occupied[1].sum() == 1
        assert (cell < 64 * 64).sum(-1).min() > ek.KEYS_PER_PASS
    if case == "tile_boundary":
        for c in (ek.TILE_CELLS - 1, ek.TILE_CELLS, 64 * 64 - 1):
            assert occupied[:, c].all()

    # Values: within the JAX kernel's routing error, max(BIG) * 2^-15.
    atol = float(_big(w, t, GEO["pc_range"]).max()) * 2.0 ** -15
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_wrapper_refuses_what_the_kernels_cannot():
    rng = np.random.default_rng(4)
    pts, mask = _cloud("random", rng)
    w, t = (torch.from_numpy(a) for a in _weights(rng))
    p, m = torch.from_numpy(pts), torch.from_numpy(mask)
    # A contiguous view one float into a buffer: not 16-byte aligned.
    shifted = torch.zeros(pts.size + 1)[1:].view(pts.shape)
    shifted.copy_(p)
    for bad in (lambda: ek.pillar_canvas_fused(shifted, m, w, t, **GEO),
                lambda: ek.pillar_canvas_fused(p, m.to(torch.uint8), w, t,
                                               **GEO),
                lambda: ek.pillar_canvas_fused(p, m.float(), w, t, **GEO),
                lambda: ek.pillar_canvas_fused(
                    p, m.t().contiguous().t(), w, t, **GEO)):
        with pytest.raises(ValueError):
            bad()
    # The encoder module hands the wrapper a bool mask whatever it got.
    enc = FusedPillarEncoder(num_filters=C, **GEO).eval()
    with torch.no_grad():
        torch.testing.assert_close(enc(p, m.to(torch.uint8)), enc(p, m),
                                   rtol=0, atol=0)


def _jax_variables(rng, enc, pts, mask):
    v = enc.init(jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask))
    v = {"params": dict(v["params"]), "batch_stats": dict(v["batch_stats"])}
    # Non-trivial BN stats so the inference fold is exercised.
    v["batch_stats"]["mean"] = jnp.asarray(rng.normal(size=C) * 0.1,
                                           jnp.float32)
    v["batch_stats"]["var"] = jnp.asarray(1.0 + rng.random(C), jnp.float32)
    v["params"]["bias"] = jnp.asarray(rng.normal(size=C) * 0.1, jnp.float32)
    return v


def _port_encoder(v, dtype):
    enc = FusedPillarEncoder(num_filters=C, dtype=dtype, **GEO)
    state = {k: torch.from_numpy(np.array(a)) for k, a in
             {**v["params"], **v["batch_stats"]}.items()}
    enc.load_state_dict(state, strict=True)
    return enc.eval()        # inference: the fused kernel's path


def test_encoder_matches_jax_reference_path():
    rng = np.random.default_rng(2)
    pts, mask = _cloud("random", rng)
    slow_enc = JaxEncoder(num_filters=C, fast_inference=False,
                          dtype=jnp.float32, **GEO)
    v = _jax_variables(rng, slow_enc, pts, mask)
    want = np.asarray(slow_enc.apply(v, jnp.asarray(pts), jnp.asarray(mask),
                                     train=False)).reshape(B, -1, C)
    with torch.no_grad():
        got = _port_encoder(v, torch.float32)(
            torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
    # Same tolerance as the JAX kernel's own parity test
    # (test_pillar_paint.py::test_fast_matches_reference).
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_encoder_bf16_matches_jax_bf16_path():
    rng = np.random.default_rng(3)
    pts, mask = _cloud("random", rng)
    fast_enc = JaxEncoder(num_filters=C, dtype=jnp.bfloat16, **GEO)
    v = _jax_variables(rng, fast_enc, pts, mask)
    want = np.asarray(fast_enc.apply(v, jnp.asarray(pts), jnp.asarray(mask),
                                     train=False), np.float32)
    with torch.no_grad():
        got = _port_encoder(v, torch.bfloat16)(
            torch.from_numpy(pts), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy().reshape(want.shape)
    # The bf16 tolerance of test_pillar_paint.py's bf16 parity test.
    tol = 0.03 * max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() < tol
