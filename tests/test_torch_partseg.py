"""The port's PointNet++ part segmentation (shared MLP, network, weights,
pipeline, loss, data, training) against the JAX package's.

Inputs are made with numpy from seeds and go through both packages on
the CPU: the port with ``device="cpu"``, where the kernels' wrappers run
their plain versions, the JAX package with its XLA gathers (its Pallas
kernels run off the TPU only in interpret mode, which
``tests/test_torch_fps_gather.py`` covers).
"""

import os
import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lisec_tpu
import lisec_tpu.models.pointnet2 as jax_pointnet2
import lisec_tpu_torch
from lisec_tpu.bench_lib import save_weights_npz
from lisec_tpu.config import load_config as jax_load_config
from lisec_tpu.data.augment import augment_cloud as jax_augment_cloud
from lisec_tpu.data.collate import make_batches as jax_make_batches
from lisec_tpu.data.shapenetpart import ShapeNetPart as JaxShapeNetPart
from lisec_tpu.models.common import SharedMLP as JaxSharedMLP
from lisec_tpu.models.common import masked_max as jax_masked_max
from lisec_tpu.training.losses import cross_entropy as jax_cross_entropy
from lisec_tpu_torch.config import apply_overrides
from lisec_tpu_torch.data.augment import augment_cloud
from lisec_tpu_torch.data.collate import make_batches
from lisec_tpu_torch.data.shapenetpart import ShapeNetPart
from lisec_tpu_torch.models.common import SharedMLP, masked_max
from lisec_tpu_torch.models.pointnet2 import PointNet2PartSeg
from lisec_tpu_torch.training.losses import cross_entropy
from lisec_tpu_torch.weights import (
    convert_flax_arrays, load_weights_npz, to_flax_arrays)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "pointnet2_partseg_tiny.yaml")
FULL = os.path.join(ROOT, "configs", "pointnet2_partseg_fixture_conv.yaml")


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, col, prefix=""):
    """A flax tree -> flat ``col/prefix/Module_0/.../leaf`` numpy dict."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[f"{col}/{prefix}" + "/".join(str(p.key) for p in path)] = \
            np.asarray(leaf)
    return out


def _randomize_bn(rng, variables):
    """Non-trivial BN statistics and affine terms in every layer."""
    def fill(path, leaf):
        name = str(path[-1].key)
        if name in ("mean", "bias"):
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.1, leaf.dtype)
        if name in ("var", "scale"):
            return jnp.asarray(0.5 + rng.random(leaf.shape), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(fill, variables)


# -- shared MLP and masked max ----------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_shared_mlp_matches_flax(train):
    rng = np.random.default_rng(int(train))
    x = rng.normal(size=(2, 6, 5, 7)).astype(np.float32)
    jmlp = JaxSharedMLP((16, 8, 12))
    v = _randomize_bn(rng, jax.jit(jmlp.init)(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    g = rng.normal(size=(2, 6, 5, 12)).astype(np.float32)

    def loss(params):
        y, new = jmlp.apply({"params": params,
                             "batch_stats": v["batch_stats"]},
                            jnp.asarray(x), train,
                            mutable=["batch_stats"] if train else [])
        return jnp.sum(y * g), (y, new)
    (_, (want, new)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(v["params"])
    flat = {**_flat(v["params"], "params", "SharedMLP_0/"),
            **_flat(v["batch_stats"], "batch_stats", "SharedMLP_0/")}
    port = SharedMLP(7, (16, 8, 12))
    port.load_state_dict({k[len("fp3."):]: t for k, t in
                          convert_flax_arrays(flat).items()}, strict=True)
    port.train(train)
    xt = _t(x).requires_grad_()
    got = port(xt)
    (got * _t(g)).sum().backward()
    # f32 on both sides; the sums of the products and statistics run in
    # another order: 1e-5.
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    for k, w in _flat(grads, "params", "SharedMLP_0/").items():
        name = convert_flax_arrays({k: w})
        (pname, _), = name.items()
        p = port.get_parameter(pname[len("fp3."):])
        gp = p.grad.T if p.dim() == 2 else p.grad
        np.testing.assert_allclose(gp.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
    if train:
        for k, w in _flat(new["batch_stats"], "batch_stats",
                          "SharedMLP_0/").items():
            (bname, _), = convert_flax_arrays({k: w}).items()
            np.testing.assert_allclose(
                port.get_buffer(bname[len("fp3."):]).numpy(), w, **tol)


def test_masked_max_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 10, 4)).astype(np.float32)
    mask = rng.random((3, 10)) > 0.5
    mask[2] = False                         # no valid row: 0
    got = masked_max(_t(x), _t(mask), dim=-2).numpy()
    want = np.asarray(jax_masked_max(jnp.asarray(x), jnp.asarray(mask), -2))
    np.testing.assert_array_equal(got, want)
    assert not got[2].any()


@pytest.mark.parametrize("features", [0, 5])
def test_set_abstraction_matches_flax(features):
    """One set abstraction through the port's path (``fps_gather``: the
    picks with their xyz and mask, then ball query, grouping, shared MLP,
    max) against the JAX module, eval mode: the centres and their mask
    exactly, the features to 1e-5."""
    rng = np.random.default_rng(features)
    b, n = 2, 256
    xyz = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    mask = rng.random((b, n)) > 0.2
    feats = (rng.normal(size=(b, n, features)).astype(np.float32)
             if features else None)
    args = dict(num_samples=64, radii=(0.5,), num_neighbors=(16,),
                mlps=((16, 24),))
    jsa = jax_pointnet2.SetAbstraction(**args)
    jin = (jnp.asarray(xyz), None if feats is None else jnp.asarray(feats),
           jnp.asarray(mask))
    v = _randomize_bn(rng, jax.jit(jsa.init)(jax.random.PRNGKey(0), *jin))
    want = jax.jit(jsa.apply)(v, *jin)
    flat = {**_flat(v["params"], "params", "SetAbstraction_0/"),
            **_flat(v["batch_stats"], "batch_stats", "SetAbstraction_0/")}
    port = lisec_tpu_torch.models.pointnet2.SetAbstraction(features, **args)
    port.load_state_dict({k[len("sa.0."):]: t for k, t in
                          convert_flax_arrays(flat).items()}, strict=True)
    port.eval()
    with torch.no_grad():
        got = port(_t(xyz), None if feats is None else _t(feats), _t(mask))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # f32 on both sides; the MLP's sums run in another order: 1e-5.
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)


# -- the network ------------------------------------------------------------

@pytest.mark.parametrize("msg", [False, True])
def test_network_eval_matches_flax(msg):
    """Both groupings at width 1 on small clouds, from flax's init with
    random BN statistics carried across by ``weights.py``."""
    rng = np.random.default_rng(10 + msg)
    b, n, ncat, nparts = 2, 192, 4, 12
    pts = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    mask = rng.random((b, n)) > 0.1
    onehot = np.eye(ncat, dtype=np.float32)[[1, 3]]
    jmodel = jax_pointnet2.PointNet2PartSeg(num_parts=nparts,
                                            num_categories=ncat, msg=msg)
    args = (jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(onehot))
    v = _randomize_bn(rng, jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                *args))
    want = np.asarray(jax.jit(jmodel.apply)(v, *args))
    flat = {**_flat(v["params"], "params"),
            **_flat(v["batch_stats"], "batch_stats")}
    port = PointNet2PartSeg(num_parts=nparts, num_categories=ncat, msg=msg)
    port.load_state_dict(convert_flax_arrays(flat), strict=True)
    port.eval()
    with torch.no_grad():
        got = port(_t(pts), _t(mask), _t(onehot)).numpy()
    # f32 on both sides, the Dense and BN sums in another order, through
    # eleven layers: 1e-4 of the largest logit.
    assert got.shape == want.shape == (b, n, nparts)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def jax_pipe():
    return lisec_tpu.build_model(jax_load_config(TINY))


@pytest.fixture(scope="module")
def port_pipe():
    return lisec_tpu_torch.build_model(lisec_tpu_torch.load_config(TINY),
                                       device="cpu")


@pytest.fixture(scope="module")
def tiny_state(jax_pipe, tmp_path_factory):
    """JAX ``init_state(0)``'s weights (its ``init_variables`` under
    ``jit``, which draws the same bits in a sixth of the eager time), its
    first unshuffled batch, and the same weights in an .npz for the
    port."""
    dummy = jax.tree.map(jnp.asarray, jax_pipe.dummy_batch())
    v = jax.jit(jax_pipe.init_variables)(jax.random.PRNGKey(0), dummy)
    state = types.SimpleNamespace(params=v["params"],
                                  batch_stats=v["batch_stats"])
    cfg = jax_pipe.cfg
    batch = next(jax_make_batches(
        jax_pipe.make_dataset("train"), cfg.budget, cfg.train.batch_size,
        shuffle=False))
    path = str(tmp_path_factory.mktemp("partseg") / "init.npz")
    save_weights_npz(state, path)
    return state, batch, path


def test_weights_round_trip_every_key(port_pipe, tiny_state):
    _, _, path = tiny_state
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    state = convert_flax_arrays(flat)
    model = port_pipe.model
    assert len(state) == len(flat) == len(model.state_dict()) == 88
    load_weights_npz(model, path)
    back = to_flax_arrays(model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # Dense kernels (in, out) become nn.Linear weights (out, in).
    k = "params/SetAbstraction_1/SharedMLP_0/Dense_0/kernel"
    assert flat[k].shape == (3 + 128, 128)
    assert state["sa.1.mlps.0.dense.0.weight"].shape == (128, 3 + 128)
    assert state["head_out.bias"].shape == (12,)
    with pytest.raises(KeyError):
        convert_flax_arrays({"params/SetAbstraction_0/Dense_0/kernel":
                             flat[k]})


def test_tiny_predict_matches_golden_and_jax(jax_pipe, port_pipe,
                                             tiny_state):
    state, batch, path = tiny_state
    want = jax.device_get(jax_pipe.infer(state, batch))
    load_weights_npz(port_pipe.model, path)
    got = lisec_tpu_torch.infer(port_pipe, batch, device="cpu")
    assert got["labels"].dtype == torch.int32
    golden = np.load(os.path.join(ROOT, "tests", "goldens",
                                  "pointnet2_partseg_tiny.npz"))
    np.testing.assert_array_equal(got["labels"].numpy(), golden["labels"])
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"],
                               rtol=0,
                               atol=1e-4 * np.abs(want["logits"]).max())
    assert not port_pipe.model.training


@pytest.fixture
def identity_dropout(monkeypatch):
    """The JAX network with its dropout made the identity (a test-side
    patch: flax's dropout bits cannot be drawn by torch)."""
    nn = types.SimpleNamespace(**{k: getattr(flax.linen, k)
                                  for k in dir(flax.linen)})
    nn.Dropout = lambda rate, deterministic=None: (lambda x: x)
    monkeypatch.setattr(jax_pointnet2, "nn", nn)


def _port_loss_and_grads(pipe, path, batch):
    """Train-mode ``pipe.loss`` from the weights at ``path``, dropout off:
    (loss, aux, flax-named gradients, flax-named state after the step)."""
    load_weights_npz(pipe.model, path)
    pipe.model.dropout_rate = 0.0
    pipe.model.train()
    pipe.model.zero_grad()
    try:
        total, aux = pipe.loss(pipe.device_batch(batch))
        total.backward()
    finally:
        pipe.model.eval()
        pipe.model.dropout_rate = 0.4
    grads = to_flax_arrays(pipe.model, {
        n: p.grad for n, p in pipe.model.named_parameters()})
    return float(total.detach()), aux, grads, to_flax_arrays(pipe.model)


def _batch_norm_f64_sums(xf, layer, channel_dim, *, momentum, eps):
    """``models/common.py::batch_norm`` in train mode with its batch
    statistics summed in f64 and rounded to f32 once."""
    dims = [d for d in range(xf.dim()) if d != channel_dim % xf.dim()]
    mean = xf.double().mean(dim=dims).float()
    var = ((xf.double() ** 2).mean(dim=dims).float()
           - mean * mean).clamp_min(0)
    mul = torch.rsqrt(var + eps) * layer.scale
    return (xf - mean) * mul + layer.bias


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_pipeline_loss_and_gradients_match_jax(jax_pipe, port_pipe,
                                               tiny_state, identity_dropout,
                                               monkeypatch):
    """Train-mode ``pipeline.loss`` of both packages from the same weights
    and batch, dropout the identity on both sides."""
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
    total, aux, got_grads, got_state = _port_loss_and_grads(
        port_pipe, path, batch)

    # f32 on both sides, the gathers exact on both: the loss to 1e-5
    # (measured 9e-7), the accuracy exactly, the running statistics to
    # 1e-4.
    np.testing.assert_allclose(total, float(want), rtol=1e-5)
    assert float(aux["acc"]) == float(want_aux["acc"])
    for k, w in _flat(new_bs, "batch_stats").items():
        np.testing.assert_allclose(got_state[k], w, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert set(got_grads) == set(want_grads)
    assert len(want_grads) == len(list(port_pipe.model.parameters())) == 54
    gnorm = float(optax.global_norm(grads))
    np.testing.assert_allclose(
        np.sqrt(sum(float((g ** 2).sum()) for g in got_grads.values())),
        gnorm, rtol=1e-3)                                 # measured 1.2e-4
    # Two tensors have no gradient in exact arithmetic: the head's Dense
    # bias and the global feature's last BN bias both feed a train-mode BN
    # that takes out any per-channel constant. Both sides hold f32 noise
    # there, far below the global norm.
    zero = {"params/Dense_0/bias",
            "params/GlobalSetAbstraction_0/SharedMLP_0/BatchNorm_2/bias"}
    for k in zero:
        assert np.linalg.norm(want_grads[k]) < 1e-5 * gnorm, k
        assert np.linalg.norm(got_grads[k]) < 1e-5 * gnorm, k
    # The rest: within 0.05 of each tensor's L2 norm (measured 0.018 deep
    # in the set abstractions, 6e-5 at the head's last layer). The train-
    # mode BNs take E[x^2] - E[x]^2 over up to 131,072 rows in f32, XLA
    # and torch sum them in other orders, and this small net amplifies
    # that: its train-mode logits already differ by 2.4e-4 of the largest.
    # The port's own gradients move by more than 0.1% of some tensor's
    # norm when only its batch statistics are summed in f64 (measured
    # 0.4%), so such a spread is f32 rounding, not a fault.
    for k, w in want_grads.items():
        if k not in zero:
            assert _rel(got_grads[k], w) < 0.05, (k, _rel(got_grads[k], w))
    import lisec_tpu_torch.models.common as common
    monkeypatch.setattr(common, "batch_norm", _batch_norm_f64_sums)
    _, _, f64_grads, _ = _port_loss_and_grads(port_pipe, path, batch)
    moved = max(_rel(f64_grads[k], g) for k, g in got_grads.items()
                if k not in zero)
    assert 1e-3 < moved < 0.05, moved


def test_dropout_keeps_its_share_scales_and_repeats():
    model = PointNet2PartSeg(num_parts=4, num_categories=2).train()
    h = torch.ones((64, 512))
    masks = []
    for seed in (3, 3, 4):
        out = model.dropout(h, torch.Generator().manual_seed(seed))
        assert set(torch.unique(out).tolist()) <= {
            0.0, float(torch.tensor(1.0) / 0.6)}
        masks.append(out != 0)
    share = float(masks[0].float().mean())
    assert abs(share - 0.6) < 0.01                 # keep with 1 - 0.4
    assert torch.equal(masks[0], masks[1])         # same generator state
    assert not torch.equal(masks[0], masks[2])
    assert torch.equal(model.eval().dropout(h, None), h)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 20, 6)).astype(np.float32) * 3
    labels = rng.integers(-1, 6, (3, 20)).astype(np.int32)
    mask = rng.random((3, 20)) > 0.3
    weights = rng.random(6).astype(np.float32) + 0.5
    for kw in ({}, {"mask": mask}, {"mask": mask, "class_weights": weights}):
        got = cross_entropy(_t(logits), _t(labels),
                            **{k: _t(v) for k, v in kw.items()})
        want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- data -------------------------------------------------------------------

@pytest.mark.parametrize("dropout_max", [0.0, 0.5])
def test_augment_cloud_is_bit_equal_to_jax(dropout_max):
    cfg = apply_overrides(lisec_tpu_torch.load_config(FULL), [
        "data.augment.rotate_z=true",
        f"data.augment.dropout_max={dropout_max}"])
    sample = ShapeNetPart(cfg, "train")[5]
    got = augment_cloud(sample, np.random.default_rng((1, 2, 3)),
                        cfg.data.augment)
    want = jax_augment_cloud(sample, np.random.default_rng((1, 2, 3)),
                             cfg.data.augment)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not np.array_equal(got["points"], sample["points"])


def _write_shapenet_files(root, rng):
    """A two-category ShapeNetPart tree in the real file layout."""
    root.mkdir()
    (root / "synsetoffset2category.txt").write_text(
        "Airplane\t02691156\nChair\t03001627\n")
    for synset, counts in (("02691156", (70, 130)), ("03001627", (90,))):
        (root / synset).mkdir()
        for i, n in enumerate(counts):
            arr = np.concatenate([rng.normal(size=(n, 6)),
                                  rng.integers(0, 4, (n, 1))], axis=1)
            np.savetxt(root / synset / f"{i:04d}.txt", arr, fmt="%.6f")


@pytest.mark.parametrize("source", ["fixture", "files"])
def test_dataset_and_batches_are_bit_identical(source, tmp_path):
    over = ["data.num_points=100", "budget.max_points=128",
            "train.batch_size=2"]
    if source == "files":
        _write_shapenet_files(tmp_path / "shapenet",
                              np.random.default_rng(0))
        over += ["data.fixture=false", f"data.root={tmp_path / 'shapenet'}"]
    else:
        over += ["data.fixture_size=6"]
    cfg = apply_overrides(lisec_tpu_torch.load_config(FULL), over)
    jcfg = jax_load_config(FULL)
    jcfg = __import__("lisec_tpu.config", fromlist=["x"]).apply_overrides(
        jcfg, over)
    for split in ("train", "test"):
        got, want = ShapeNetPart(cfg, split), JaxShapeNetPart(jcfg, split)
        assert len(got) == len(want) == (6 if source == "fixture" else 3)
        for i in range(len(want)):
            a, w = got[i], want[i]
            assert a.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(a[k], w[k], err_msg=k)
    aug = lambda s, r: augment_cloud(s, r, cfg.data.augment)  # noqa: E731
    jaug = lambda s, r: jax_augment_cloud(s, r, jcfg.data.augment)  # noqa
    for a, w in zip(make_batches(got, cfg.budget, 2, seed=7, epochs=1,
                                 augment_fn=aug),
                    jax_make_batches(want, jcfg.budget, 2, seed=7, epochs=1,
                                     augment_fn=jaug)):
        assert a.keys() == w.keys() == {"points", "point_mask",
                                        "point_labels", "category"}
        for k in w:
            assert a[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(a[k], w[k], err_msg=k)


# -- the pipeline and training ----------------------------------------------

def test_train_lowers_loss_on_tiny():
    cfg = apply_overrides(lisec_tpu_torch.load_config(TINY), [
        "train.num_steps=6", "train.log_every=3", "train.batch_size=2",
        "data.fixture_size=4", "data.num_points=256",
        "budget.max_points=256"])
    pipe, history = lisec_tpu_torch.train(cfg, device="cpu", progress=False)
    assert [h["step"] for h in history] == [1, 3, 6]
    assert set(history[0]) == {"step", "lr", "clouds_per_sec", "loss",
                               "grad_norm", "acc"}
    assert all(np.isfinite(v) for h in history for v in h.values())
    assert history[-1]["loss"] < history[0]["loss"]
    assert pipe.step == 6 and pipe.model.training


def test_partseg_is_registered_seed_initialised_and_evaluate_raises():
    from lisec_tpu_torch.pipelines.partseg import PointNet2PartSegPipeline
    from lisec_tpu_torch.registry import get_model, get_pipeline
    assert get_pipeline("pointnet2_partseg") is PointNet2PartSegPipeline
    assert get_model("pointnet2_partseg") is PointNet2PartSeg
    cfg = lisec_tpu_torch.load_config(TINY)
    pipes = [PointNet2PartSegPipeline(cfg, device="cpu", seed=s)
             for s in (0, 0, 1)]
    s0, s1, s2 = (p.model.state_dict() for p in pipes)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    w = s0["sa.1.mlps.0.dense.0.weight"]
    assert not torch.equal(w, s2["sa.1.mlps.0.dense.0.weight"])
    # lecun-normal: std = fan_in^-1/2.
    np.testing.assert_allclose(float(w.std()), (3 + 128) ** -0.5, rtol=0.1)
    assert not pipes[0].model.training
    assert set(pipes[0].evaluate(max_batches=1)) == {"class_miou",
                                                     "instance_miou"}
    full = lisec_tpu_torch.load_config(FULL)
    fp = PointNet2PartSegPipeline(full, device="cpu")
    assert fp.num_parts == 50 and fp.num_categories == 16
    assert fp.augment_fn("train") is not None and fp.augment_fn("test") is None
