"""Point-axis sharding (``lisec_tpu_torch/parallel/point_sharded.py``):
``fps_sharded`` and ``ball_query_sharded`` on 4 gloo ranks equal the
port's single-device ops and the JAX package's single-device ops and
mesh programs exactly, including a shard whose points are all masked.
Inputs come from seeds (``tests/test_point_sharded.py``'s recipes)."""

import numpy as np
import pytest
import torch

from lisec_tpu_torch.ops.ball_query import ball_query
from lisec_tpu_torch.ops.cuda.fps import fps
from lisec_tpu_torch.parallel import (
    ball_query_sharded, fps_sharded, make_mesh, run_ranks)

torch.set_num_threads(1)

WORLD = 4


def _cases():
    rng = np.random.default_rng(0)
    fps_cases = []
    for n, m, masked in ((1024, 64, "random"), (512, 32, "first_shard"),
                         (256, 16, "all"), (512, 32, "none_ties")):
        pts = rng.normal(size=(n, 3)).astype(np.float32)
        if masked == "random":
            mask = rng.random(n) > 0.1
        else:
            mask = np.ones(n, bool)
            if masked == "first_shard":
                mask[:n // WORLD] = False
            elif masked == "all":
                mask[:] = False
            else:                   # a coarse lattice: ties everywhere
                pts = np.round(pts * 2) / 2
        fps_cases.append((pts, mask, m))
    n, m, k = 1024, 32, 16
    pts = rng.uniform(0, 4, (n, 3)).astype(np.float32)
    ctr = rng.uniform(0, 4, (m, 3)).astype(np.float32)
    mask = rng.random(n) > 0.1
    empty = mask.copy()
    empty[n // WORLD:2 * n // WORLD] = False
    bq_cases = [(ctr, pts, mask, 0.8, k), (ctr, pts, empty, 0.8, k),
                (ctr, pts, mask, 0.3, 40)]
    return fps_cases, bq_cases


def _rank(fps_cases, bq_cases):
    mesh = make_mesh(0, "cpu")
    n_of = lambda a: len(a) // mesh.world           # noqa: E731
    rows = lambda a: torch.from_numpy(              # noqa: E731
        a[mesh.rank * n_of(a):(mesh.rank + 1) * n_of(a)])
    return ([fps_sharded(rows(p), rows(msk), m, mesh)
             for p, msk, m in fps_cases],
            [ball_query_sharded(torch.from_numpy(c), rows(p), rows(msk),
                                radius=r, num_neighbors=k, mesh=mesh)
             for c, p, msk, r, k in bq_cases])


@pytest.fixture(scope="module")
def sharded():
    cases = _cases()
    return cases, run_ranks(_rank, WORLD, *cases, device="cpu")


def test_fps_sharded_equals_the_single_device_ops(sharded):
    import jax.numpy as jnp
    from lisec_tpu.ops.fps import farthest_point_sampling
    (fps_cases, _), ranks = sharded
    for i, (pts, mask, m) in enumerate(fps_cases):
        want = fps(torch.from_numpy(pts)[None], torch.from_numpy(mask)[None],
                   m)[0]
        jax_want = np.asarray(farthest_point_sampling(
            jnp.asarray(pts), jnp.asarray(mask), m, use_pallas=False))
        np.testing.assert_array_equal(want.numpy(), jax_want)
        for r in ranks:
            assert r[0][i].dtype == torch.int32
            np.testing.assert_array_equal(r[0][i].numpy(), jax_want,
                                          err_msg=str(i))
        if mask.any():
            assert mask[want.numpy()].all()
    # The all-masked first shard is never picked.
    assert (ranks[0][0][1].numpy() >= 512 // WORLD).all()


def test_ball_query_sharded_equals_the_single_device_ops(sharded):
    import jax.numpy as jnp
    from lisec_tpu.ops.ball_query import ball_query as jax_ball_query
    (_, bq_cases), ranks = sharded
    for i, (ctr, pts, mask, radius, k) in enumerate(bq_cases):
        want = ball_query(torch.from_numpy(ctr), torch.from_numpy(pts),
                          torch.from_numpy(mask), radius=radius,
                          num_neighbors=k)
        jax_want = np.asarray(jax_ball_query(
            jnp.asarray(ctr), jnp.asarray(pts), jnp.asarray(mask),
            radius=radius, num_neighbors=k))
        np.testing.assert_array_equal(want.numpy(), jax_want)
        for r in ranks:
            assert r[1][i].dtype == torch.int32
            np.testing.assert_array_equal(r[1][i].numpy(), jax_want,
                                          err_msg=str(i))


def test_point_sharded_equals_the_jax_mesh_programs(sharded, eight_devices):
    """The JAX package's ``fps_sharded`` and ``ball_query_sharded`` on its
    8-device mesh give the port's 4-rank indices."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from lisec_tpu.parallel.point_sharded import (
        ball_query_sharded as jax_bq, fps_sharded as jax_fps)
    (fps_cases, bq_cases), ranks = sharded
    mesh = Mesh(np.asarray(eight_devices), ("points",))
    pts, mask, m = fps_cases[0]
    np.testing.assert_array_equal(
        ranks[0][0][0].numpy(),
        np.asarray(jax_fps(jnp.asarray(pts), jnp.asarray(mask), m, mesh)))
    ctr, pts, mask, radius, k = bq_cases[0]
    np.testing.assert_array_equal(
        ranks[0][1][0].numpy(),
        np.asarray(jax_bq(jnp.asarray(ctr), jnp.asarray(pts),
                          jnp.asarray(mask), radius=radius,
                          num_neighbors=k, mesh=mesh)))


def test_one_rank_is_the_single_device_op():
    fps_cases, bq_cases = _cases()
    mesh = make_mesh(0, "cpu")
    for pts, mask, m in fps_cases:
        got = fps_sharded(torch.from_numpy(pts), torch.from_numpy(mask), m,
                          mesh)
        want = fps(torch.from_numpy(pts)[None], torch.from_numpy(mask)[None],
                   m)[0]
        assert torch.equal(got, want)
    for ctr, pts, mask, radius, k in bq_cases:
        got = ball_query_sharded(
            torch.from_numpy(ctr), torch.from_numpy(pts),
            torch.from_numpy(mask), radius=radius, num_neighbors=k,
            mesh=mesh)
        assert torch.equal(got, ball_query(
            torch.from_numpy(ctr), torch.from_numpy(pts),
            torch.from_numpy(mask), radius=radius, num_neighbors=k))
