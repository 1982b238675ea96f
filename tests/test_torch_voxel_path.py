"""The port's voxel-buffer PointPillars (``model.params.fused: false``)
against the JAX package's: ``pillar_scatter``, ``pillar_scatter_max``,
the single-cloud ``voxelize``, ``PillarFeatureNet``, the model's weight
map, and the tiny pipeline's predict, loss and gradients.

Inputs are made with numpy from seeds and go through both packages on
the CPU (the port with ``device="cpu"``, where the paint wrapper runs its
plain version; the JAX package jitted, its Pallas paint in interpret
mode).
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lisec_tpu
import lisec_tpu_torch
from lisec_tpu.bench_lib import save_weights_npz
from lisec_tpu.config import apply_overrides as jax_apply_overrides
from lisec_tpu.config import load_config as jax_load_config
from lisec_tpu.data.collate import make_batches as jax_make_batches
from lisec_tpu.models.pointpillars import (
    PillarFeatureNet as JaxPillarFeatureNet)
from lisec_tpu.ops import scatter as jax_scatter
from lisec_tpu_torch.config import apply_overrides
from lisec_tpu_torch.models.pointpillars import PillarFeatureNet, PointPillars
from lisec_tpu_torch.ops import scatter
from lisec_tpu_torch.weights import (
    convert_flax_arrays, load_weights_npz, to_flax_arrays)

# Both packages' ``ops`` export a function named ``voxelize`` over its
# module.
jvox = importlib.import_module("lisec_tpu.ops.voxelize")
pvox = importlib.import_module("lisec_tpu_torch.ops.voxelize")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "pointpillars_tiny.yaml")
VOXEL_PATH = ["model.params.fused=false"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, col):
    """A flax tree -> flat ``col/Module_0/.../leaf`` numpy dict."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[col + "/" + "/".join(str(p.key) for p in path)] = np.asarray(leaf)
    return out


# -- pillar_scatter and pillar_scatter_max ------------------------------------

NY, NX = 6, 7


def _pillars(rng, p=24, c=5):
    """Pillar features and coords on an (NY, NX) grid: valid pillars own
    distinct cells; pillar 20 has y = -1 (invalid), 21 y = NY with x = 0
    (the trash row), 22 x = -1 (-1: the trash row), 23 x = -3 (counts
    from the end, into cell NY * NX - 2, which no other pillar owns)."""
    feats = rng.normal(size=(p, c)).astype(np.float32)
    cells = rng.permutation(NY * NX - 2)[:p]
    coords = np.stack([np.zeros(p, np.int64), cells // NX, cells % NX],
                      -1).astype(np.int32)
    coords[20] = (0, -1, 3)
    coords[21] = (0, NY, 0)
    coords[22] = (0, 0, -1)
    coords[23] = (0, 0, -3)
    return feats, coords


@pytest.mark.parametrize("num_voxels", [24, 17, 0])
def test_pillar_scatter_matches_jax(num_voxels):
    rng = np.random.default_rng(num_voxels)
    feats, coords = _pillars(rng)
    want, vjp = jax.vjp(lambda f: jax_scatter.pillar_scatter(
        f, jnp.asarray(coords), jnp.int32(num_voxels), ny=NY, nx=NX),
        jnp.asarray(feats))
    ft = _t(feats).requires_grad_()
    got = scatter.pillar_scatter(ft, _t(coords), torch.tensor(num_voxels),
                                 ny=NY, nx=NX)
    assert got.shape == (5, NY, NX)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    # The backward is the gather of the canvas cotangent.
    cot = rng.normal(size=want.shape).astype(np.float32)
    got.backward(_t(cot))
    np.testing.assert_array_equal(ft.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(cot))[0]))

    # Batched: each cloud as the single-cloud call, one channels-last
    # canvas.
    feats2, coords2 = _pillars(rng)
    counts = np.array([num_voxels, 24], np.int32)
    got = scatter.pillar_scatter(_t(np.stack([feats, feats2])),
                                 _t(np.stack([coords, coords2])),
                                 _t(counts), ny=NY, nx=NX)
    assert got.shape == (2, 5, NY, NX)
    assert got.is_contiguous(memory_format=torch.channels_last)
    for i, (f, c) in enumerate(((feats, coords), (feats2, coords2))):
        want = jax_scatter.pillar_scatter(
            jnp.asarray(f), jnp.asarray(c), jnp.int32(counts[i]), ny=NY,
            nx=NX)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_pillar_scatter_max_matches_jax():
    rng = np.random.default_rng(3)
    n, c, cells = 64, 3, 10
    feats = rng.normal(size=(n, c)).astype(np.float32)
    feats[5, 1] = np.inf                 # a non-finite max becomes 0
    feats[6, 2] = -np.inf
    feats[7, 0] = np.nan
    voxel = rng.integers(-2, cells + 3, n).astype(np.int32)
    voxel[5:8] = (2, 9, 4)
    voxel[8:12] = (-1, cells, cells + 1, cells + 7)   # dropped, trash, out
    want = jax_scatter.pillar_scatter_max(
        jnp.asarray(feats), jnp.asarray(voxel), num_cells=cells)
    got = scatter.pillar_scatter_max(_t(feats), _t(voxel), num_cells=cells)
    assert got.shape == (cells, c) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[2, 1] == 0 and got[4, 0] == 0      # the inf and the nan


# -- voxelize -----------------------------------------------------------------

def test_voxelize_matches_jax():
    """The single-cloud wrapper, with a crowd in the first cells that
    overflows K and more non-empty cells than P."""
    rng = np.random.default_rng(11)
    n = 3000
    pts = np.concatenate([rng.uniform(-1, 17, (n, 1)),
                          rng.uniform(-9, 9, (n, 1)),
                          rng.uniform(-3.5, 1.5, (n, 1)),
                          rng.random((n, 1))], -1).astype(np.float32)
    pts[:200, :3] = np.array([4.1, -7.9, -1.05]) + 0.3 * rng.random((200, 3))
    mask = rng.random(n) > 0.1
    geo = dict(pc_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0),
               voxel_size=(0.5, 0.5, 4.0), grid_size=(32, 32, 1),
               max_voxels=400, max_points_per_voxel=8)
    want = jax.device_get(jvox.voxelize(jnp.asarray(pts), jnp.asarray(mask),
                                        **geo))
    got = pvox.voxelize(_t(pts), _t(mask), **geo)
    assert got.voxels.shape == (400, 8, 4)
    # The JAX table routes f32 through two bf16 terms (2^-17 relative);
    # tests/test_torch_voxelize.py's tolerance.
    np.testing.assert_allclose(got.voxels.numpy(), want.voxels, rtol=1e-5,
                               atol=1e-6)
    for k in ("coords", "num_points", "num_voxels", "point_voxel"):
        w = np.asarray(getattr(want, k))
        g = getattr(got, k).numpy()
        assert g.dtype == np.int32 and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert int(got.num_voxels) == 400 and int(got.num_points.max()) == 8


# -- PillarFeatureNet ---------------------------------------------------------

def _pfn_inputs(rng, b=2, p=40, k=6):
    nx, ny = 20, 16
    cells = np.stack([rng.permutation(nx * ny)[:p] for _ in range(b)])
    coords = np.stack([np.zeros_like(cells), cells // nx, cells % nx],
                      -1).astype(np.int32)
    num = rng.integers(0, k + 1, (b, p)).astype(np.int32)
    num[:, -5:] = 0                         # empty rows at the end
    coords[:, -5:] = -1
    vox = np.zeros((b, p, k, 4), np.float32)
    for i in range(b):
        for j in range(p):
            cy, cx = coords[i, j, 1], coords[i, j, 2]
            n = num[i, j]
            vox[i, j, :n, 0] = (cx + rng.random(n)) * 0.16
            vox[i, j, :n, 1] = (cy + rng.random(n)) * 0.16 - 1.28
            vox[i, j, :n, 2] = rng.uniform(-3, 1, n)
            vox[i, j, :n, 3] = rng.random(n)
    return vox, coords, num


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True])
def test_pillar_feature_net_matches_flax(dtype, train):
    rng = np.random.default_rng(7)
    vox, coords, num = _pfn_inputs(rng)
    geo = dict(voxel_size=(0.16, 0.16), pc_range_min=(0.0, -1.28))
    jdt = jnp.dtype(dtype)
    net = JaxPillarFeatureNet(16, dtype=jdt, **geo)
    v = net.init(jax.random.PRNGKey(0), vox, coords, num)
    # Non-trivial BN parameters and statistics.
    params = {"Dense_0": v["params"]["Dense_0"], "BatchNorm_0": {
        "scale": jnp.asarray(0.5 + rng.random(16), jnp.float32),
        "bias": jnp.asarray(rng.normal(size=16) * 0.1, jnp.float32)}}
    stats = {"BatchNorm_0": {
        "mean": jnp.asarray(rng.normal(size=16) * 0.1, jnp.float32),
        "var": jnp.asarray(0.5 + rng.random(16), jnp.float32)}}
    variables = {"params": params, "batch_stats": stats}
    if train:
        want, mut = net.apply(variables, vox, coords, num, train=True,
                              mutable=["batch_stats"])
    else:
        want = net.apply(variables, vox, coords, num)

    port = PillarFeatureNet(16, dtype=getattr(torch, dtype), **geo)
    flat = {**_flat(params, "params/PillarFeatureNet_0"),
            **_flat(stats, "batch_stats/PillarFeatureNet_0")}
    state = convert_flax_arrays(flat, "pointpillars")
    port.load_state_dict({k[len("pfn."):]: t for k, t in state.items()},
                         strict=True)
    port.train(train)
    with torch.no_grad():
        got = port(_t(vox), _t(coords), _t(num))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == want.shape
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(got[:, -5:], 0.0)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        # bf16 keeps 8 significant bits: both sides round the Dense, the
        # normalised value and the max to bf16, from f32 sums taken in
        # another order, so an output may land one bf16 step (2^-8 of
        # its size) away: 1e-2 relative, and 1e-2 of the largest output
        # absolute.
        np.testing.assert_allclose(
            got, want, rtol=1e-2, atol=1e-2 * float(np.abs(want).max()))
    if train:
        new = _flat(mut["batch_stats"], "batch_stats/PillarFeatureNet_0")
        for key, w in new.items():
            leaf = key.rsplit("/", 1)[1]
            np.testing.assert_allclose(getattr(port.bn, leaf).numpy(), w,
                                       rtol=1e-5, atol=1e-6, err_msg=key)


# -- the tiny fused=false pipeline --------------------------------------------

@pytest.fixture(scope="module")
def jax_pipe():
    return lisec_tpu.build_model(
        jax_apply_overrides(jax_load_config(TINY), VOXEL_PATH))


@pytest.fixture(scope="module")
def port_pipe():
    return lisec_tpu_torch.build_model(
        apply_overrides(lisec_tpu_torch.load_config(TINY), VOXEL_PATH),
        device="cpu")


@pytest.fixture(scope="module")
def tiny_state(jax_pipe, tmp_path_factory):
    """JAX ``init_state(0)``, its first unshuffled batch, and the same
    weights in an .npz for the port."""
    state = jax_pipe.init_state(0)
    cfg = jax_pipe.cfg
    batch = next(jax_make_batches(
        jax_pipe.make_dataset("train"), cfg.budget, cfg.train.batch_size,
        shuffle=False))
    path = str(tmp_path_factory.mktemp("voxel_path") / "init.npz")
    save_weights_npz(state, path)
    return state, batch, path


def test_weights_round_trip_every_key(port_pipe, tiny_state):
    _, _, path = tiny_state
    model = port_pipe.model
    assert isinstance(model, PointPillars) and not port_pipe.fused
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    state = convert_flax_arrays(flat, model.FLAX_KEYS)
    assert len(state) == len(flat) == len(model.state_dict())
    assert state["pfn.dense.weight"].shape == (32, 9)
    load_weights_npz(model, path)
    back = to_flax_arrays(model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert {k.split("/")[1] for k in flat} == {
        "PillarFeatureNet_0", "BEVBackbone_0", "AnchorHead_0"}


def test_tiny_predict_matches_jax(jax_pipe, port_pipe, tiny_state):
    state, batch, path = tiny_state
    want = jax.device_get(jax_pipe.infer(state, batch))
    load_weights_npz(port_pipe.model, path)
    got = lisec_tpu_torch.infer(
        port_pipe, {k: batch[k] for k in ("points", "point_mask")},
        device="cpu")
    got = {k: v.numpy() for k, v in got.items()}
    # Keep sets and labels exactly, boxes and scores to 1e-4.
    assert want["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    assert not port_pipe.model.training


def test_pipeline_loss_and_gradients_match_jax(jax_pipe, port_pipe,
                                               tiny_state):
    """``pipeline.loss`` and its gradients through the voxel buffer, the
    pillar feature net and the scatter, from the same weights and batch."""
    state, batch, path = tiny_state
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def jax_loss_and_grad(params):
        return jax.value_and_grad(
            lambda p: jax_pipe.loss(p, state.batch_stats, jbatch,
                                    jax.random.PRNGKey(0), train=True),
            has_aux=True)(params)
    (want, (want_aux, new_bs)), grads = jax_loss_and_grad(state.params)
    want_grads = _flat(grads, "params")
    want_stats = _flat(new_bs, "batch_stats")

    pipe = port_pipe
    load_weights_npz(pipe.model, path)
    pipe.model.train()
    pipe.model.zero_grad()
    total, aux = pipe.loss(pipe.device_batch(batch))
    total.backward()
    pipe.model.eval()

    # f32 end to end on both sides: 1e-4 on the loss and its terms, as in
    # tests/test_torch_train.py.
    assert float(want_aux["num_pos"]) > 0
    np.testing.assert_allclose(float(total.detach()), float(want),
                               rtol=1e-4)
    assert set(aux) == set(want_aux)
    for k in want_aux:
        np.testing.assert_allclose(float(aux[k].detach()),
                                   float(want_aux[k]), rtol=1e-4, err_msg=k)
    got_grads = to_flax_arrays(pipe.model, {
        n: p.grad for n, p in pipe.model.named_parameters()})
    assert set(got_grads) == set(want_grads)
    gnorm = np.sqrt(sum(float((g ** 2).sum()) for g in got_grads.values()))
    np.testing.assert_allclose(
        gnorm, float(optax.global_norm(grads)), rtol=1e-3)
    # The JAX voxel table routes f32 through two bf16 terms (2^-17
    # relative) and this small net amplifies it (batch statistics over a
    # 4x4 map, relu kinks; noise of 4 f32 ulps on the feature net's output
    # alone moves a gradient tensor by 1.2% of its norm): each tensor is
    # held to 0.10 of its own L2 norm (measured 0.037), the limit
    # tests/test_torch_train.py sets for that routing.
    for k, w in want_grads.items():
        rel = np.linalg.norm(got_grads[k] - w) / np.linalg.norm(w)
        assert rel < 0.10, (k, rel)
    got_state = to_flax_arrays(pipe.model)
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_state[k], w, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    moved = [k for k, w in _flat(state.batch_stats, "batch_stats").items()
             if not np.allclose(got_state[k], w)]
    assert len(moved) == len(want_stats)          # every BN layer moved


def test_train_step_runs_and_moves_every_parameter(port_pipe, tiny_state):
    """``train_step`` on the voxel path: autograd through the scatter and
    the feature net; the voxelizer has no gradient."""
    _, batch, path = tiny_state
    pipe = port_pipe
    pipe.init_state(0)
    load_weights_npz(pipe.model, path)
    before = {k: v.clone() for k, v in pipe.model.state_dict().items()}
    aux = pipe.train_step(batch)
    assert np.isfinite(float(aux["loss"])) and pipe.step == 1
    moved = [k for k, v in pipe.model.state_dict().items()
             if not torch.equal(v, before[k])]
    assert len(moved) == len(before)
