"""The port's PointPillars (convs, backbone, head, weights, the whole
predict) and its fixture copy against the JAX package's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import lisec_tpu
from lisec_tpu.bench_lib import save_weights_npz
from lisec_tpu.config import load_config as jax_load_config
from lisec_tpu.data.collate import make_batches
from lisec_tpu.data.fixtures import (
    make_detection_scene_hard as jax_scene)
from lisec_tpu.models.common import ConvBNRelu as JaxConvBNRelu
from lisec_tpu.models.pointpillars import AnchorHead as JaxHead
from lisec_tpu.models.pointpillars import BEVBackbone as JaxBackbone
import lisec_tpu_torch
from lisec_tpu_torch.data.fixtures import make_detection_scene_hard
from lisec_tpu_torch.models.common import ConvBNRelu
from lisec_tpu_torch.models.pointpillars import AnchorHead, BEVBackbone
from lisec_tpu_torch.weights import convert_flax_arrays, load_weights_npz

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "pointpillars_tiny.yaml")
KITTI = os.path.join(ROOT, "configs", "pointpillars_kitti.yaml")
SNAPSHOT = os.path.join(ROOT, "weights", "pointpillars_fixture_hard.npz")


def _flat(variables, prefix=""):
    """flax variables -> save_weights_npz-style flat numpy dict."""
    out = {}
    for col, tree in variables.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(p.key) for p in path)
            out[f"{col}/{prefix}{key}"] = np.asarray(leaf)
    return out


def _randomize_bn(rng, variables):
    """Non-trivial BN statistics and affine terms, so the fold and the
    normalisation are exercised."""
    def fill(path, leaf):
        name = str(path[-1].key)
        if name in ("mean", "bias"):
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.1, leaf.dtype)
        if name in ("var", "scale"):
            return jnp.asarray(0.5 + rng.random(leaf.shape), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(fill, variables)


def _load(module, state, prefix):
    module.load_state_dict(
        {k[len(prefix):]: v for k, v in state.items()
         if k.startswith(prefix)}, strict=True)


@pytest.mark.parametrize("kernel,stride,transpose", [
    (3, 1, False), (3, 2, False), (2, 2, True), (4, 4, True)])
def test_conv_mapping(kernel, stride, transpose):
    rng = np.random.default_rng(kernel * 10 + stride)
    x = rng.normal(size=(2, 12, 10, 6)).astype(np.float32)     # NHWC
    layer = JaxConvBNRelu(5, kernel=kernel, stride=stride,
                          transpose=transpose)
    v = _randomize_bn(rng, layer.init(jax.random.PRNGKey(0), x))
    want = np.asarray(layer.apply(v, x))
    flat = _flat(v, "BEVBackbone_0/ConvBNRelu_0/")
    port = ConvBNRelu(6, 5, kernel, stride, transpose=transpose)
    _load(port, convert_flax_arrays(flat), "backbone.layers.0.")
    port.eval()                   # running statistics, as flax's default
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_snapshot_fills_full_width_model():
    pipe = lisec_tpu_torch.build_model(lisec_tpu_torch.load_config(KITTI),
                                       device="cpu")
    with np.load(SNAPSHOT) as data:
        flat = {k: data[k] for k in data.files}
    state = convert_flax_arrays(flat)
    assert len(state) == len(flat) == len(pipe.model.state_dict()) == 106
    load_weights_npz(pipe.model, SNAPSHOT)
    for k, v in pipe.model.state_dict().items():
        assert torch.equal(v, state[k]), k
    enc = pipe.model.encoder
    assert enc.kernel.shape == (9, 64) and enc.grid == (432, 496)
    with pytest.raises(KeyError):
        convert_flax_arrays({**flat, "params/Extra_0/kernel": flat[
            "params/FusedPillarEncoder_0/kernel"]})
    del flat["batch_stats/FusedPillarEncoder_0/var"]
    with pytest.raises(RuntimeError):
        pipe.model.load_state_dict(convert_flax_arrays(flat), strict=True)


class _Net(nn.Module):
    @nn.compact
    def __call__(self, x):
        bev = JaxBackbone(layer_nums=(1, 2, 2), filters=(8, 16, 24),
                          up_filters=(8, 8, 8))(x)
        return JaxHead(num_classes=2, num_anchors_per_cell=4)(bev)


def test_backbone_and_head_match_flax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 32, 24, 6)).astype(np.float32)     # NHWC
    net = _Net()
    v = _randomize_bn(rng, net.init(jax.random.PRNGKey(1), x))
    want = net.apply(v, x)
    state = convert_flax_arrays(_flat(v))
    backbone = BEVBackbone(6, (1, 2, 2), (2, 2, 2), (8, 16, 24), (1, 2, 4),
                           (8, 8, 8))
    head = AnchorHead(24, num_classes=2, num_anchors_per_cell=4)
    _load(backbone, state, "backbone.")
    _load(head, state, "head.")
    backbone.eval()
    with torch.no_grad():
        got = head(backbone(torch.from_numpy(x).permute(0, 3, 1, 2)))
    for k in ("cls", "box", "dir"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4)


def test_tiny_predict_matches_golden_and_jax(tmp_path):
    cfg = jax_load_config(TINY)
    jax_pipe = lisec_tpu.build_model(cfg)
    state = jax_pipe.init_state(0)
    batch = next(make_batches(jax_pipe.make_dataset("train"), cfg.budget,
                              cfg.train.batch_size, shuffle=False))
    want = jax.device_get(jax_pipe.infer(state, batch))
    path = str(tmp_path / "tiny.npz")
    save_weights_npz(state, path)

    pipe = lisec_tpu_torch.build_model(lisec_tpu_torch.load_config(TINY),
                                       device="cpu")
    load_weights_npz(pipe.model, path)
    got = lisec_tpu_torch.infer(
        pipe, {k: batch[k] for k in ("points", "point_mask")}, device="cpu")
    got = {k: v.numpy() for k, v in got.items()}

    # Keep sets exactly (the kept boxes are distinct rows).
    assert want["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    # The golden's own tolerance (test_goldens.py::_check_or_regen).
    golden = np.load(os.path.join(ROOT, "tests", "goldens",
                                  "pointpillars_tiny.npz"))
    for k in ("boxes", "scores", "labels"):
        np.testing.assert_allclose(got[k], golden[k], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_fixture_copy_is_bit_identical(seed):
    got = make_detection_scene_hard(seed)
    want = jax_scene(seed)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
