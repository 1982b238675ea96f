"""The port's voxelizers against the JAX package's.

Inputs are made with numpy from seeds. The JAX functions run jitted on
the CPU with their Pallas paint in interpret mode; the port runs on CPU
tensors, where the paint wrapper computes its plain version. Coords,
counts and point-to-voxel maps are integers and must be equal exactly.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lisec_tpu_torch.models.second import mean_vfe

# Both packages' ``ops`` export a function named ``voxelize`` over its
# module.
jvox = importlib.import_module("lisec_tpu.ops.voxelize")
pvox = importlib.import_module("lisec_tpu_torch.ops.voxelize")
torch.set_num_threads(1)

PC_RANGE = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _geometry(voxel_size):
    grid = tuple(int(round((PC_RANGE[i + 3] - PC_RANGE[i]) / voxel_size[i]))
                 for i in range(3))
    return dict(pc_range=PC_RANGE, voxel_size=voxel_size, grid_size=grid)


def _clouds(rng, b, n, crowd=0):
    """Clouds over a bit more than the range, some points masked; the
    first ``crowd`` points of every cloud sit in a few cells so that the
    per-cell budget overflows."""
    lo = np.array([PC_RANGE[0] - 1, PC_RANGE[1] - 1, PC_RANGE[2] - 0.5, 0.0])
    hi = np.array([PC_RANGE[3] + 1, PC_RANGE[4] + 1, PC_RANGE[5] + 0.5, 1.0])
    pts = (lo + (hi - lo) * rng.random((b, n, 4))).astype(np.float32)
    if crowd:
        pts[:, :crowd, :3] = (np.array([4.1, 1.1, -1.05])
                              + 0.6 * rng.random((b, crowd, 3)))
    mask = rng.random((b, n)) > 0.1
    return pts, mask


# -- cell assignment ----------------------------------------------------------

@pytest.mark.parametrize("size", [0.05, 0.1, 0.25, 0.5])
def test_point_cell_ids_on_cell_edges(size):
    """Points exactly on cell edges: the jitted JAX program multiplies by
    the f32 reciprocal of the voxel size, and so does the port."""
    geo = _geometry((size, size, size))
    nx, ny, nz = geo["grid_size"]
    rng = np.random.default_rng(int(size * 100))
    n = 4096
    idx = np.stack([rng.integers(0, g + 1, n) for g in (nx, ny, nz)], -1)
    pts = np.zeros((1, n, 4), np.float32)
    pts[0, :, :3] = (idx.astype(np.float32) * np.float32(size)
                     + np.asarray(PC_RANGE[:3], np.float32))
    mask = np.ones((1, n), bool)
    want_cell, want_in = jax.jit(lambda p, m: jvox.point_cell_ids(
        p, m, PC_RANGE, geo["voxel_size"], geo["grid_size"]))(
            jnp.asarray(pts), jnp.asarray(mask))
    got_cell, got_in = pvox.point_cell_ids(
        _t(pts), _t(mask), PC_RANGE, geo["voxel_size"], geo["grid_size"])
    assert got_cell.dtype == torch.int32
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    np.testing.assert_array_equal(got_cell.numpy(), np.asarray(want_cell))
    assert 0.3 < float(got_in.float().mean()) < 1.0
    # Points far outside the range do not wrap around into it.
    far = np.array([[[1e12, 0.0, 0.0, 0.0], [-1e12, 0.0, 0.0, 0.0],
                     [1.0, 3e38, 0.0, 0.0]]], np.float32)
    cell, inside = pvox.point_cell_ids(
        _t(far), torch.ones((1, 3), dtype=torch.bool), PC_RANGE,
        geo["voxel_size"], geo["grid_size"])
    assert not inside.any() and (cell == nx * ny * nz).all()


# -- both voxelizers ----------------------------------------------------------

CASES = {
    # Budgets hold everything.
    "roomy": dict(voxel_size=(0.5, 0.5, 0.25), n=600, max_voxels=640,
                  max_points_per_voxel=8, crowd=0),
    # More than K points in some cells: dropped in point-index order.
    "cell_overflow": dict(voxel_size=(0.5, 0.5, 0.25), n=600, max_voxels=640,
                          max_points_per_voxel=3, crowd=200),
    # More cells than P: dropped in cell-id order.
    "voxel_overflow": dict(voxel_size=(0.5, 0.5, 0.25), n=600, max_voxels=96,
                           max_points_per_voxel=5, crowd=100),
    # A finer grid with a non-binary voxel size.
    "fine": dict(voxel_size=(0.1, 0.1, 0.2), n=500, max_voxels=512,
                 max_points_per_voxel=5, crowd=50),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    spec = CASES[request.param]
    rng = np.random.default_rng(len(request.param))
    pts, mask = _clouds(rng, 2, spec["n"], spec["crowd"])
    mask[1, 50:] &= request.param != "roomy"       # a nearly empty cloud
    kw = dict(_geometry(spec["voxel_size"]), max_voxels=spec["max_voxels"],
              max_points_per_voxel=spec["max_points_per_voxel"])
    jp, jm = jnp.asarray(pts), jnp.asarray(mask)
    return (request.param, pts, mask, kw,
            jax.device_get(jvox.voxelize_batch(jp, jm, **kw)),
            jax.device_get(jvox.voxelize_mean_batch(jp, jm, **kw)))


def test_voxelize_batch_matches_jax(case):
    name, pts, mask, kw, want, _ = case
    got = pvox.voxelize_batch(_t(pts), _t(mask), **kw)
    for k in ("coords", "num_points", "num_voxels", "point_voxel"):
        g = getattr(got, k)
        assert g.dtype == torch.int32, k
        np.testing.assert_array_equal(g.numpy(), getattr(want, k), err_msg=k)
    # The JAX paint routes each value as two bf16 terms (2^-17 relative);
    # the port places the f32 values exactly: 1e-5 relative.
    np.testing.assert_allclose(got.voxels.numpy(), want.voxels, rtol=1e-5,
                               atol=1e-6)
    assert int(got.num_voxels[0]) > 50
    kk, p = kw["max_points_per_voxel"], kw["max_voxels"]
    if name == "cell_overflow":
        assert int((got.num_points == kk).sum()) > 3
        # A full cell holds its first K points in point-index order.
        v = int(torch.nonzero(got.num_points[0] == kk)[0])
        members = np.flatnonzero(got.point_voxel[0].numpy() == v)
        np.testing.assert_array_equal(got.voxels[0, v].numpy(),
                                      pts[0][members])
        assert (np.diff(members) > 0).all() and len(members) == kk
    if name == "voxel_overflow":
        assert int(got.num_voxels[0]) == p
        assert (got.point_voxel[0] == -1).sum() > (~_t(mask[0])).sum()
    # Ascending cell order, -1 on the empty rows.
    nx, ny, _ = kw["grid_size"]
    for b in range(2):
        nv = int(got.num_voxels[b])
        c = got.coords[b].long()
        lin = (c[:, 0] * ny + c[:, 1]) * nx + c[:, 2]
        assert (lin[1:nv] > lin[:nv - 1]).all()
        assert (got.coords[b, nv:] == -1).all()
        assert (got.num_points[b, nv:] == 0).all()


def test_voxelize_mean_batch_matches_jax_and_the_mean_identity(case):
    _, pts, mask, kw, _, want = case
    got = pvox.voxelize_mean_batch(_t(pts), _t(mask), **kw)
    for k in ("coords", "num_points", "num_voxels"):
        g = getattr(got, k)
        assert g.dtype == torch.int32, k
        np.testing.assert_array_equal(g.numpy(), getattr(want, k), err_msg=k)
    # As above: the JAX paint's two-term routing of sums of up to K
    # values, 1e-5 relative.
    np.testing.assert_allclose(got.feats.numpy(), want.feats, rtol=1e-5,
                               atol=1e-6)
    # mean_vfe(voxelize_batch(...)) == voxelize_mean_batch(...): the same
    # values summed in f32 there and in f64 here, 1e-6.
    full = pvox.voxelize_batch(_t(pts), _t(mask), **kw)
    for k in ("coords", "num_points", "num_voxels"):
        assert torch.equal(getattr(full, k), getattr(got, k)), k
    np.testing.assert_allclose(
        mean_vfe(full.voxels, full.num_points).numpy(), got.feats.numpy(),
        rtol=1e-6, atol=1e-6)


def test_mean_vfe_matches_jax():
    from lisec_tpu.models.second import mean_vfe as jax_mean_vfe
    rng = np.random.default_rng(4)
    voxels = rng.normal(size=(2, 30, 5, 4)).astype(np.float32)
    counts = rng.integers(0, 6, (2, 30)).astype(np.int32)
    want = np.asarray(jax_mean_vfe(jnp.asarray(voxels), jnp.asarray(counts)))
    got = mean_vfe(_t(voxels), _t(counts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got[counts == 0] == 0).all()
