"""The port's classification (PointNet and PointNet++ on ModelNet40:
MLP head, T-Net, networks, weights, pipelines, loss, data, training)
against the JAX package's.

Inputs are made with numpy from seeds and go through both packages on
the CPU: the port with ``device="cpu"``, where the kernels' wrappers run
their plain versions, the JAX package with its XLA sampling and gathers
(its Pallas kernels run off the TPU only in interpret mode, which
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
import lisec_tpu.models.common as jax_common
import lisec_tpu.models.pointnet2 as jax_pointnet2
import lisec_tpu_torch
from lisec_tpu.bench_lib import save_weights_npz
from lisec_tpu.config import apply_overrides as jax_apply_overrides
from lisec_tpu.config import load_config as jax_load_config
from lisec_tpu.data.augment import augment_cloud as jax_augment_cloud
from lisec_tpu.data.collate import make_batches as jax_make_batches
from lisec_tpu.data.modelnet40 import ModelNet40 as JaxModelNet40
from lisec_tpu.models.common import MLPHead as JaxMLPHead
from lisec_tpu.models.pointnet import TNet as JaxTNet
from lisec_tpu.models.pointnet import PointNetCls as JaxPointNetCls
from lisec_tpu.models.pointnet import orthogonality_loss as jax_ortho
from lisec_tpu.ops.ball_query import ball_query as jax_ball_query
from lisec_tpu.ops.fps import farthest_point_sampling as jax_fps
from lisec_tpu_torch.config import apply_overrides
from lisec_tpu_torch.data.augment import augment_cloud
from lisec_tpu_torch.data.collate import make_batches
from lisec_tpu_torch.data.fixtures import make_cls_cloud
from lisec_tpu_torch.data.modelnet40 import ModelNet40, normalize_cloud
from lisec_tpu_torch.models.common import MLPHead
from lisec_tpu_torch.models.pointnet import (
    PointNetCls, TNet, orthogonality_loss)
from lisec_tpu_torch.models.pointnet2 import PointNet2Cls
from lisec_tpu_torch.ops.ball_query import ball_query
from lisec_tpu_torch.ops.cuda.fps import fps
from lisec_tpu_torch.weights import (
    convert_flax_arrays, load_weights_npz, to_flax_arrays)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "pointnet_modelnet40_tiny.yaml")
FULL = os.path.join(ROOT, "configs", "pointnet_cls_fixture_conv.yaml")
PN2 = os.path.join(ROOT, "configs", "pointnet2_modelnet40.yaml")
# PointNet++ at its config's widths, points and classes, on fixture
# clouds, at batch 8 (the CPU's share). The head's train-mode BNs
# normalise (B, C) rows, their variance E[x^2] - E[x]^2 in f32 over B
# rows: at batch 2 that cancellation, summed in another order by XLA and
# torch, moves the loss by 7e-4 relative; at batch 8 it stays inside 1e-5.
PN2_OVERRIDES = ["data.fixture=true", "data.fixture_size=8",
                 "train.batch_size=8", "data.augment.enabled=false"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, col, prefix=""):
    """A flax tree -> flat ``col/prefix/Module_0/.../leaf`` numpy dict."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[f"{col}/{prefix}" + "/".join(str(p.key) for p in path)] = \
            np.asarray(leaf)
    return out


def _randomize(rng, variables):
    """Non-trivial BN statistics and affine terms in every layer, and a
    T-Net output layer that is not zero."""
    def fill(path, leaf):
        name = str(path[-1].key)
        if name in ("mean", "bias"):
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.1, leaf.dtype)
        if name in ("var", "scale"):
            return jnp.asarray(0.5 + rng.random(leaf.shape), leaf.dtype)
        if name == "kernel" and not np.asarray(leaf).any():
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.01,
                               leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(fill, variables)


def _port_from_flax(port, v, prefix="", strip="", keys="pointnet_cls"):
    """Load flax variables (nested under ``prefix`` in the flat keys)
    into ``port``, whose names are the converted ones (by the ``keys``
    map) less ``strip``."""
    flat = {**_flat(v["params"], "params", prefix),
            **_flat(v["batch_stats"], "batch_stats", prefix)}
    state = {k[len(strip):]: t
             for k, t in convert_flax_arrays(flat, keys).items()}
    port.load_state_dict(state, strict=True)
    return port


def _rel_close(got, want, rtol):
    """Within ``rtol`` of the largest |want| (f32 sums in another order)."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


# -- MLP head and T-Net -------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_mlp_head_matches_flax(train):
    """Dense (no bias), BN (statistics from the batch's B rows in
    training), ReLU per hidden layer, then a Dense with a bias; dropout
    0 so that both sides are deterministic in training."""
    rng = np.random.default_rng(int(train))
    x = rng.normal(size=(6, 12)).astype(np.float32)
    jhead = JaxMLPHead((16, 8), 5, dropout_rate=0.0)
    v = _randomize(rng, jax.jit(jhead.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    g = rng.normal(size=(6, 5)).astype(np.float32)

    def loss(params):
        y, new = jhead.apply({"params": params,
                              "batch_stats": v["batch_stats"]},
                             jnp.asarray(x), train,
                             mutable=["batch_stats"] if train else [])
        return jnp.sum(y * g), (y, new)
    (_, (want, new)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(v["params"])
    port = _port_from_flax(MLPHead(12, (16, 8), 5, dropout_rate=0.0), v,
                           "MLPHead_0/", "head.").train(train)
    assert port.dense[0].bias is None and port.dense[2].bias is not None
    xt = _t(x).requires_grad_()
    got = port(xt)
    (got * _t(g)).sum().backward()
    # f32 on both sides, sums in another order: 1e-5 relative.
    _rel_close(got.detach().numpy(), np.asarray(want), 1e-5)
    # PointNetCls's names and key map, so that to_flax_arrays names them.
    holder = torch.nn.Module()
    holder.head, holder.FLAX_KEYS = port, PointNetCls.FLAX_KEYS
    got_grads = to_flax_arrays(holder, {
        n: p.grad for n, p in holder.named_parameters()})
    for k, w in _flat(grads, "params").items():
        _rel_close(got_grads[k.replace("params/", "params/MLPHead_0/")],
                   w, 1e-5)
    if train:
        got_state = to_flax_arrays(holder)
        for k, w in _flat(new["batch_stats"], "batch_stats").items():
            np.testing.assert_allclose(
                got_state[k.replace("stats/", "stats/MLPHead_0/")], w,
                rtol=1e-5, atol=1e-6)


def test_batch_norm_of_one_row_in_training():
    """At batch 1 the batch variance of a (B, C) input is 0: the output
    is the BN bias, as flax's is."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(1, 12)).astype(np.float32)
    jhead = JaxMLPHead((16,), 3, dropout_rate=0.0)
    v = _randomize(rng, jax.jit(jhead.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    want, _ = jhead.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    port = _port_from_flax(MLPHead(12, (16,), 3, dropout_rate=0.0), v,
                           "MLPHead_0/", "head.").train()
    got = port(_t(x)).detach().numpy()
    _rel_close(got, np.asarray(want), 1e-5)
    bn_out = port.bn[0](port.dense[0](_t(x))).detach().numpy()
    np.testing.assert_allclose(bn_out[0], port.bn[0].bias.detach().numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("k", [3, 64])
def test_tnet_matches_flax(k):
    """Eval mode, random weights with a non-zero output layer, a cloud
    with a masked tail and an all-masked one."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(3, 40, k)).astype(np.float32)
    mask = np.ones((3, 40), bool)
    mask[1, 25:] = False
    mask[2] = False
    jt = JaxTNet(k=k)
    args = (jnp.asarray(x), jnp.asarray(mask))
    v = _randomize(rng, jax.jit(jt.init)(jax.random.PRNGKey(0), *args))
    want = np.asarray(jax.jit(jt.apply)(v, *args))
    port = _port_from_flax(TNet(k), v, "TNet_0/", "tnets.0.").eval()
    with torch.no_grad():
        got = port(_t(x), _t(mask)).numpy()
    assert got.shape == want.shape == (3, k, k)
    _rel_close(got, want, 1e-5)


def test_seed_initialised_tnet_is_the_identity():
    cfg = apply_overrides(lisec_tpu_torch.load_config(FULL),
                          ["data.num_points=64", "budget.max_points=64"])
    pipe = lisec_tpu_torch.build_model(cfg, device="cpu")
    pipe.init_state(3)
    assert [t.k for t in pipe.model.tnets] == [3, 64]
    x = torch.randn((2, 64, 3), generator=torch.Generator().manual_seed(0))
    mask = torch.ones((2, 64), dtype=torch.bool)
    for tnet, inp in zip(pipe.model.tnets, (x, torch.randn((2, 64, 64)))):
        assert not tnet.out.weight.any() and not tnet.out.bias.any()
        with torch.no_grad():
            out = tnet.train()(inp, mask)
        assert torch.equal(out, torch.eye(tnet.k).expand(2, -1, -1))
    # Every other kernel is drawn: lecun-normal, std fan_in^-1/2.
    w = pipe.model.tnets[1].mlps[1].dense[0].weight.detach()
    np.testing.assert_allclose(float(w.std()), 1024 ** -0.5, rtol=0.1)


def test_orthogonality_loss_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(4, 64, 64)).astype(np.float32) * 0.2
    got = float(orthogonality_loss(_t(a)))
    want = float(jax_ortho(jnp.asarray(a)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(orthogonality_loss(None)) == float(jax_ortho(None)) == 0.0


# -- the networks -------------------------------------------------------------

def test_pointnet_cls_eval_matches_flax():
    """Both T-Nets, 40 classes, clouds with a masked tail and an
    all-masked one, from flax's init with random BN statistics and T-Net
    outputs carried across by ``weights.py``."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-1, 1, (3, 96, 3)).astype(np.float32)
    mask = np.ones((3, 96), bool)
    mask[1, 60:] = False
    mask[2] = False
    jm = JaxPointNetCls(num_classes=40)
    args = (jnp.asarray(pts), jnp.asarray(mask))
    v = _randomize(rng, jax.jit(jm.init)(jax.random.PRNGKey(0), *args))
    want = jax.jit(jm.apply)(v, *args)
    port = _port_from_flax(PointNetCls(num_classes=40), v).eval()
    with torch.no_grad():
        got = port(_t(pts), _t(mask))
    # f32 on both sides, the Dense and BN sums in another order: 1e-5 of
    # the largest value.
    _rel_close(got["logits"].numpy(), np.asarray(want["logits"]), 1e-5)
    _rel_close(got["feature_transform"].numpy(),
               np.asarray(want["feature_transform"]), 1e-5)


@pytest.fixture(scope="module")
def pn2_cloud():
    """Two fixture clouds at the config's 1,024 points, the second with a
    masked tail, and PointNet2Cls at the config's widths from flax's
    init with random BN statistics."""
    cfg = apply_overrides(lisec_tpu_torch.load_config(PN2), PN2_OVERRIDES)
    pts = np.stack([normalize_cloud(make_cls_cloud(10_000 + i, c, 1024))
                    for i, c in ((0, 5), (1, 18))]).astype(np.float32)
    mask = np.ones((2, 1024), bool)
    mask[1, 700:] = False
    jm = jax_pointnet2.PointNet2Cls(num_classes=cfg.data.num_classes)
    args = (jnp.asarray(pts), jnp.asarray(mask))
    v = _randomize(np.random.default_rng(5),
                   jax.jit(jm.init)(jax.random.PRNGKey(0), *args))
    return cfg, pts, mask, jm, v


def test_pointnet2_sampling_and_grouping_indices_equal_jax(pn2_cloud):
    """FPS picks (SA1 1,024 -> 512, SA2 512 -> 128) and ball-query
    neighbours of both levels, exactly."""
    _, pts, mask, _, _ = pn2_cloud
    xyz, m = pts, mask
    for num, radius, k in ((512, 0.2, 32), (128, 0.4, 64)):
        want = np.asarray(jax_fps(jnp.asarray(xyz), jnp.asarray(m), num))
        got = fps(_t(xyz), _t(m), num).numpy()
        np.testing.assert_array_equal(got, want)
        centers = np.take_along_axis(xyz, want[..., None].astype(int), 1)
        want_nbr = np.asarray(jax_ball_query(
            jnp.asarray(centers), jnp.asarray(xyz), jnp.asarray(m),
            radius=radius, num_neighbors=k))
        got_nbr = ball_query(_t(centers), _t(xyz), _t(m), radius=radius,
                             num_neighbors=k).numpy()
        np.testing.assert_array_equal(got_nbr, want_nbr)
        xyz, m = centers, np.take_along_axis(m, want.astype(int), 1)


def test_pointnet2_cls_eval_matches_flax(pn2_cloud):
    cfg, pts, mask, jm, v = pn2_cloud
    want = jax.jit(jm.apply)(v, jnp.asarray(pts), jnp.asarray(mask))
    port = _port_from_flax(PointNet2Cls(num_classes=cfg.data.num_classes),
                           v, keys=PointNet2Cls.FLAX_KEYS).eval()
    with torch.no_grad():
        got = port(_t(pts), _t(mask))
    assert got["feature_transform"] is None
    assert want["feature_transform"] is None
    _rel_close(got["logits"].numpy(), np.asarray(want["logits"]), 1e-5)


# -- weights and the pipelines ------------------------------------------------

def _jax_init(path, overrides=()):
    """JAX ``init_state(0)``'s weights (its ``init_variables`` under
    ``jit``, the same bits as eager), the config and the pipeline."""
    cfg = jax_apply_overrides(jax_load_config(path), list(overrides))
    pipe = lisec_tpu.build_model(cfg)
    dummy = jax.tree.map(jnp.asarray, pipe.dummy_batch())
    v = jax.jit(pipe.init_variables)(jax.random.PRNGKey(0), dummy)
    return pipe, types.SimpleNamespace(params=v["params"],
                                       batch_stats=v["batch_stats"])


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    jax_pipe, state = _jax_init(TINY)
    path = str(tmp_path_factory.mktemp("cls") / "tiny.npz")
    save_weights_npz(state, path)
    port = lisec_tpu_torch.build_model(lisec_tpu_torch.load_config(TINY),
                                       device="cpu")
    return jax_pipe, state, path, port


@pytest.mark.parametrize("config,keys", [
    ("tiny", 64), ("full", 91), ("pointnet2", 59)])
def test_weights_round_trip_every_key(config, keys, tmp_path):
    path, over = {"tiny": (TINY, []), "full": (FULL, []),
                  "pointnet2": (PN2, PN2_OVERRIDES)}[config]
    _, state = _jax_init(path, over)
    npz = str(tmp_path / "w.npz")
    save_weights_npz(state, npz)
    with np.load(npz) as data:
        flat = {k: data[k] for k in data.files}
    model = lisec_tpu_torch.build_model(
        apply_overrides(lisec_tpu_torch.load_config(path), over),
        device="cpu").model
    converted = convert_flax_arrays(flat, model.FLAX_KEYS)
    assert len(converted) == len(flat) == len(model.state_dict()) == keys
    load_weights_npz(model, npz)
    back = to_flax_arrays(model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    if config == "pointnet2":
        # The head's hidden Dense layers carry a bias.
        assert converted["head.dense.0.bias"].shape == (512,)
        assert converted["head.dense.2.weight"].shape == (40, 256)
    else:
        tnet = "params/TNet_0/Dense_0/kernel"
        assert converted["tnets.0.out.weight"].shape == \
            flat[tnet].shape[::-1]
        assert "head.dense.0.bias" not in converted
    with pytest.raises(KeyError):
        convert_flax_arrays({"params/TNet_0/Conv_0/kernel": np.zeros(1)},
                            model.FLAX_KEYS)


def test_tiny_predict_matches_golden_and_jax(tiny):
    jax_pipe, state, path, port = tiny
    cfg = jax_pipe.cfg
    batch = next(jax_make_batches(jax_pipe.make_dataset("train"),
                                  cfg.budget, cfg.train.batch_size,
                                  shuffle=False))
    want = jax.device_get(jax_pipe.infer(state, batch))
    load_weights_npz(port.model, path)
    got = lisec_tpu_torch.infer(port, batch, device="cpu")
    assert got["labels"].dtype == torch.int32
    golden = np.load(os.path.join(ROOT, "tests", "goldens",
                                  "pointnet_cls_tiny.npz"))
    np.testing.assert_array_equal(got["labels"].numpy(), golden["labels"])
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    for ref in (golden["logits"], want["logits"]):
        np.testing.assert_allclose(got["logits"].numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
    assert not port.model.training


@pytest.fixture
def identity_dropout(monkeypatch):
    """The JAX networks with their dropout made the identity (a test-side
    patch: flax's dropout bits cannot be drawn by torch)."""
    nn = types.SimpleNamespace(**{k: getattr(flax.linen, k)
                                  for k in dir(flax.linen)})
    nn.Dropout = lambda rate, deterministic=None: (lambda x: x)
    monkeypatch.setattr(jax_common, "nn", nn)
    monkeypatch.setattr(jax_pointnet2, "nn", nn)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("config", ["tiny", "both_tnets", "pointnet2"])
def test_pipeline_loss_and_gradients_match_jax(config, identity_dropout,
                                               tmp_path):
    """Train-mode ``pipeline.loss`` of both packages from the same
    weights (JAX ``init_state(0)``'s, the T-Nets' output layers made
    non-zero) and the first unshuffled batch, dropout the identity."""
    path, over = {"tiny": (TINY, []),
                  "both_tnets": (TINY, ["model.params.use_input_tnet=true"]),
                  "pointnet2": (PN2, PN2_OVERRIDES)}[config]
    jax_pipe, state = _jax_init(path, over)
    params = _randomize(np.random.default_rng(2), {
        "params": state.params})["params"]
    # Only the T-Nets' zero kernels are filled: restore everything else.
    params = jax.tree_util.tree_map_with_path(
        lambda p, new, old: new if "TNet" in str(p) and str(p[-1].key)
        == "kernel" else old, params, state.params)
    cfg = jax_pipe.cfg
    batch = next(jax_make_batches(jax_pipe.make_dataset("train"),
                                  cfg.budget, cfg.train.batch_size,
                                  shuffle=False))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, (want_aux, new_bs)), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_pipe.loss(p, state.batch_stats, jbatch,
                                jax.random.PRNGKey(0), train=True),
        has_aux=True))(params)
    npz = str(tmp_path / "w.npz")
    save_weights_npz(types.SimpleNamespace(
        params=params, batch_stats=state.batch_stats), npz)

    port = lisec_tpu_torch.build_model(
        apply_overrides(lisec_tpu_torch.load_config(path), over),
        device="cpu")
    load_weights_npz(port.model, npz)
    port.model.head.dropout_rate = 0.0
    port.model.train()
    total, aux = port.loss(port.device_batch(batch))
    total.backward()
    port.model.eval()
    got_grads = to_flax_arrays(port.model, {
        n: p.grad for n, p in port.model.named_parameters()})
    got_state = to_flax_arrays(port.model)

    # f32 on both sides: the loss and its terms to 1e-5, the accuracy
    # exactly, the running statistics to 1e-4.
    np.testing.assert_allclose(float(total), float(want), rtol=1e-5)
    for k in ("ce", "reg"):
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]),
                                   rtol=1e-5, atol=1e-7)
    assert float(aux["acc"]) == float(want_aux["acc"])
    for k, w in _flat(new_bs, "batch_stats").items():
        np.testing.assert_allclose(got_state[k], w, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    want_grads = _flat(grads, "params")
    assert set(got_grads) == set(want_grads)
    gnorm = float(optax.global_norm(grads))
    # Within 0.05 of each tensor's L2 norm: the train-mode BNs take
    # E[x^2] - E[x]^2 in f32, summed in another order (as
    # test_torch_partseg.py measures). Biases that feed a train-mode BN
    # have no gradient in exact arithmetic and hold f32 noise on both
    # sides, far below the global norm.
    for k, w in want_grads.items():
        if np.linalg.norm(w) < 1e-6 * gnorm:
            assert np.linalg.norm(got_grads[k]) < 1e-5 * gnorm, k
            continue
        assert _rel(got_grads[k], w) < 0.05, (k, _rel(got_grads[k], w))


def test_accuracy_and_labels_take_the_first_of_tied_logits(tiny):
    """``jnp.argmax`` gives the lower index of a tie; so do the port's
    ``loss`` accuracy and ``predict`` labels."""
    _, _, _, port = tiny
    tied = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0],
                         [0.0, 0.0, 5.0, 5.0]])
    real = port.model.forward
    port.model.forward = lambda *a, **k: {"logits": tied,
                                          "feature_transform": None}
    try:
        batch = {"points": torch.zeros((3, 4, 3)),
                 "point_mask": torch.ones((3, 4), dtype=torch.bool),
                 "label": torch.tensor([1, 0, 3], dtype=torch.int32)}
        _, aux = port.loss(batch)
        labels = port.predict(batch)["labels"]
    finally:
        port.model.forward = real
    want = np.argmax(np.asarray(tied), -1)
    assert labels.tolist() == want.tolist() == [1, 0, 2]
    assert float(aux["acc"]) == float(jnp.mean(
        jnp.argmax(jnp.asarray(tied), -1) == jnp.asarray([1, 0, 3])))


# -- data ---------------------------------------------------------------------

def _write_modelnet_files(root, rng):
    """A three-class ModelNet40 tree in the real file layout, one cloud
    shorter than ``num_points`` (it is tiled)."""
    root.mkdir()
    names = ["airplane", "night_stand", "chair"]
    (root / "shape_names.txt").write_text("\n".join(names) + "\n")
    ids = {"train": [], "test": []}
    for c, name in enumerate(names):
        (root / name).mkdir()
        for i, n in enumerate((130, 70 + 20 * c)):
            sid = f"{name}_{i + 1:04d}"
            np.savetxt(root / name / f"{sid}.txt",
                       rng.normal(size=(n, 6)), fmt="%.6f", delimiter=",")
            ids["train" if i == 0 else "test"].append(sid)
    for split, lst in ids.items():
        (root / f"modelnet_{split}.txt").write_text("\n".join(lst) + "\n")


@pytest.mark.parametrize("source", ["fixture", "files"])
def test_dataset_and_batches_are_bit_identical(source, tmp_path):
    over = ["data.num_points=100", "budget.max_points=128",
            "train.batch_size=2", "data.augment.dropout_max=0.875"]
    if source == "files":
        _write_modelnet_files(tmp_path / "modelnet",
                              np.random.default_rng(0))
        over += ["data.fixture=false", f"data.root={tmp_path / 'modelnet'}"]
    else:
        over += ["data.fixture=true", "data.fixture_size=6"]
    cfg = apply_overrides(lisec_tpu_torch.load_config(PN2), over)
    jcfg = jax_apply_overrides(jax_load_config(PN2), over)
    for split in ("train", "test"):
        got, want = ModelNet40(cfg, split), JaxModelNet40(jcfg, split)
        assert len(got) == len(want) == (6 if source == "fixture" else 3)
        for i in range(len(want)):
            a, w = got[i], want[i]
            assert a.keys() == w.keys() == {"points", "label"}
            assert a["label"] == w["label"]
            assert a["points"].dtype == w["points"].dtype
            np.testing.assert_array_equal(a["points"], w["points"])
    aug = lambda s, r: augment_cloud(s, r, cfg.data.augment)  # noqa: E731
    jaug = lambda s, r: jax_augment_cloud(s, r, jcfg.data.augment)  # noqa
    n = 0
    for a, w in zip(make_batches(got, cfg.budget, 2, seed=7, epochs=1,
                                 augment_fn=aug),
                    jax_make_batches(want, jcfg.budget, 2, seed=7, epochs=1,
                                     augment_fn=jaug)):
        assert a.keys() == w.keys() == {"points", "point_mask", "label"}
        assert a["label"].dtype == np.int32
        for k in w:
            assert a[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(a[k], w[k], err_msg=k)
        assert not a["point_mask"][:, 100:].any()        # budget padding
        n += 1
    assert n == (3 if source == "fixture" else 1)


# -- registration and training ------------------------------------------------

def test_classifiers_are_registered_and_seed_initialised():
    from lisec_tpu_torch.pipelines.classification import (
        PointNet2ClsPipeline, PointNetClsPipeline)
    from lisec_tpu_torch.registry import get_model, get_pipeline
    assert get_pipeline("pointnet_cls") is PointNetClsPipeline
    assert get_pipeline("pointnet2_cls") is PointNet2ClsPipeline
    assert get_model("pointnet_cls") is PointNetCls
    assert get_model("pointnet2_cls") is PointNet2Cls
    cfg = lisec_tpu_torch.load_config(TINY)
    pipes = [PointNetClsPipeline(cfg, device="cpu", seed=s)
             for s in (0, 0, 1)]
    s0, s1, s2 = (p.model.state_dict() for p in pipes)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    w = s0["mlps.1.dense.2.weight"]
    assert not torch.equal(w, s2["mlps.1.dense.2.weight"])
    np.testing.assert_allclose(float(w.std()), 128 ** -0.5, rtol=0.1)
    assert not pipes[0].model.training
    assert pipes[0].reg_weight == 1e-3 and pipes[0].augment_fn("train") \
        is None
    p2 = lisec_tpu_torch.build_model(lisec_tpu_torch.load_config(PN2),
                                     device="cpu")
    assert p2.reg_weight == 0.0 and p2.augment_fn("train") is not None
    assert p2.augment_fn("test") is None
    assert p2.model.head.dense[0].bias is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            lisec_tpu_torch.build_model(cfg)


def test_train_lowers_loss_on_tiny():
    cfg = apply_overrides(lisec_tpu_torch.load_config(TINY), [
        "train.num_steps=20", "train.log_every=10", "data.fixture_size=32"])
    pipe, history = lisec_tpu_torch.train(cfg, device="cpu", progress=False)
    assert [h["step"] for h in history] == [1, 10, 20]
    assert set(history[0]) == {"step", "lr", "clouds_per_sec", "loss",
                               "grad_norm", "ce", "reg", "acc"}
    assert all(np.isfinite(v) for h in history for v in h.values())
    assert history[-1]["loss"] < history[0]["loss"]
    assert pipe.step == 20 and pipe.model.training
