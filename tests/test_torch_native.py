"""The port's host helpers ``read_velodyne``, ``pad_points`` and
``crop_range`` (``lisec_tpu_torch/native``) against the JAX package's C++
library, bit for bit, and the KITTI reader and collation that use them."""

from __future__ import annotations

import numpy as np
import pytest

import lisec_tpu.native as jax_native
from lisec_tpu.data import collate as jax_collate
from lisec_tpu.data import kitti as jax_kitti
from lisec_tpu_torch import native
from lisec_tpu_torch.data import collate, kitti


@pytest.fixture(autouse=True)
def _library_loaded():
    assert jax_native.AVAILABLE, "the JAX package's C++ helpers did not load"


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _cloud(n, c=4, seed=0):
    return np.random.default_rng(seed).normal(0, 20, (n, c)).astype(
        np.float32)


@pytest.mark.parametrize("n,max_points", [(100, 256), (256, 256),
                                          (300, 256), (0, 16)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pad_points_equals_the_library(n, max_points, dtype):
    cloud = _cloud(n).astype(dtype)
    got, want = native.pad_points(cloud, max_points), \
        jax_native.pad_points(cloud, max_points)
    for g, w in zip(got, want):
        _equal(g, w)
    assert got[1].sum() == min(n, max_points)
    for k, w in jax_collate.pad_points(cloud, max_points).items():
        _equal(collate.pad_points(cloud, max_points)[k], w)


def _edge_points():
    """Points on, just inside and just outside each face of the box
    ``[lo, hi)``, a NaN coordinate, and random points around it."""
    lo = np.array([0.0, -40.0, -3.0], np.float32)
    hi = np.array([70.4, 40.0, 1.0], np.float32)
    rows = []
    for ax in range(3):
        for v in (lo[ax], hi[ax], np.nextafter(lo[ax], np.float32(-1e9)),
                  np.nextafter(hi[ax], np.float32(-1e9))):
            p = (lo + hi) / 2
            p[ax] = v
            rows.append([*p, 0.5])
    rows.append([np.nan, 0.0, 0.0, 0.5])
    rng = np.random.default_rng(1)
    rand = rng.uniform([-10, -50, -5, 0], [80, 50, 3, 1], (200, 4))
    pts = np.concatenate([np.asarray(rows, np.float32),
                          rand.astype(np.float32)])
    return pts, lo, hi


@pytest.mark.parametrize("layout", ["contiguous_f32", "slice", "float64"])
def test_crop_range_equals_the_library_result_and_buffer(layout):
    pts, lo, hi = _edge_points()

    def make():
        if layout == "slice":
            return np.concatenate([pts, pts], 1)[:, :4]
        if layout == "float64":
            return pts.astype(np.float64)
        return pts.copy()

    mine, theirs = make(), make()
    got = native.crop_range(mine, lo, hi)
    want = jax_native.crop_range(theirs, lo, hi)
    _equal(got, want)
    assert 0 < len(got) < len(pts)
    # The library compacts a float32 C-contiguous input in place: the
    # caller's buffer changes, alike in both.
    _equal(mine, theirs)
    if layout == "contiguous_f32":
        assert not np.array_equal(mine, pts, equal_nan=True)
        assert np.shares_memory(got, mine)
    else:
        np.testing.assert_array_equal(mine, make())


def _write(path, floats):
    np.asarray(floats, np.float32).tofile(path)
    return str(path)


@pytest.mark.parametrize("case", ["over_cap", "trailing", "small_cap",
                                  "empty", "plain"])
def test_read_velodyne_equals_the_library(case, tmp_path):
    rng = np.random.default_rng(2)
    kwargs = {}
    if case == "over_cap":
        floats = rng.normal(size=4 * 300_001)
    elif case == "trailing":
        floats = rng.normal(size=4 * 50 + 3)
    elif case == "small_cap":
        floats = rng.normal(size=4 * 50)
        kwargs = {"max_points": 7}
    elif case == "empty":
        floats = []
    else:
        floats = rng.normal(size=4 * 1000)
    path = _write(tmp_path / "x.bin", floats)
    got = native.read_velodyne(path, **kwargs)
    _equal(got, jax_native.read_velodyne(path, **kwargs))
    n = min(len(floats) // 4, kwargs.get("max_points", 300_000))
    assert got.shape == (n, 4)
    np.testing.assert_array_equal(got.reshape(-1),
                                  np.asarray(floats, np.float32)[:4 * n])
    if not kwargs:                       # the KITTI reader, as shipped
        _equal(kitti.read_velodyne(path), jax_kitti.read_velodyne(path))


def test_read_velodyne_raises_on_a_missing_path(tmp_path):
    path = str(tmp_path / "missing.bin")
    with pytest.raises(IOError):
        jax_native.read_velodyne(path)
    with pytest.raises(IOError):
        native.read_velodyne(path)
    with pytest.raises(IOError):
        kitti.read_velodyne(path)
