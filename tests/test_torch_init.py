"""The port's initial weights (``models/common.py::reset_parameters``)
against the JAX package's ``init_state(seed)`` on the CPU, for each of
the seven models at a small size: the same names and shapes, and every
value equal (the draw's stated tolerance is 2 ulp; measured 0 here, so
the test asserts equality: constants, BN scales, running statistics
and every drawn kernel)."""

import os

import jax
import numpy as np
import pytest
import torch

import lisec_tpu
import lisec_tpu_torch
from lisec_tpu.config import apply_overrides as jax_apply_overrides
from lisec_tpu.config import load_config as jax_load_config
from lisec_tpu_torch.config import apply_overrides
from lisec_tpu_torch.weights import to_flax_arrays

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Each model of the port at a small size: (config, overrides).
MODELS = {
    "pointpillars_fused": ("pointpillars_tiny", []),
    "pointpillars_voxel_buffer": ("pointpillars_tiny",
                                  ["model.params.fused=false"]),
    "second": ("second_tiny", []),
    "pointnet2_partseg": ("pointnet2_partseg_tiny", []),
    "pointnet_cls": ("pointnet_modelnet40_tiny", []),
    "pointnet2_cls": ("pointnet2_modelnet40", [
        "data.fixture=true", "data.fixture_size=8", "train.batch_size=2"]),
    "rangeseg": ("rangeseg_tiny", []),
}


def jax_leaves(state):
    """The JAX state's params and batch_stats as flat numpy arrays."""
    out = {}
    for col in ("params", "batch_stats"):
        tree = getattr(state, col)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(p.key) for p in path)
            out[f"{col}/{key}"] = np.asarray(leaf)
    return out


def assert_same_draw(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_init_state_equals_jax(model):
    name, overrides = MODELS[model]
    path = os.path.join(ROOT, "configs", f"{name}.yaml")
    jax_pipe = lisec_tpu.build_model(
        jax_apply_overrides(jax_load_config(path), overrides))
    port = lisec_tpu_torch.build_model(
        apply_overrides(lisec_tpu_torch.load_config(path), overrides),
        device="cpu")
    port.init_state(3)
    want = jax_leaves(jax_pipe.init_state(3))
    assert_same_draw(to_flax_arrays(port.model), want)
    # The constants are flax's: BN scales 1, running variances 1, the
    # focal prior, the T-Nets' zero output layers.
    for k, w in want.items():
        leaf = k.rsplit("/", 1)[1]
        if leaf in ("scale", "var"):
            assert (w == 1).all(), k
        if k.endswith("AnchorHead_0/Conv_0/bias"):
            assert (w == np.float32(-4.595)).all()
        if k.split("/")[-3].startswith("TNet_") \
                and k.split("/")[-2] == "Dense_0":
            assert (w == 0).all(), k


def test_another_seed_draws_other_weights():
    cfg = lisec_tpu_torch.load_config(
        os.path.join(ROOT, "configs", "pointnet_modelnet40_tiny.yaml"))
    a = lisec_tpu_torch.build_model(cfg, device="cpu")
    b = lisec_tpu_torch.build_model(cfg, device="cpu")
    a.init_state(0)
    b.init_state(1)
    wa, wb = a.model.state_dict(), b.model.state_dict()
    drawn = [k for k in wa if not torch.equal(wa[k], wb[k])]
    assert drawn and all(k.endswith("weight") for k in drawn)
    b.init_state(0)
    assert all(torch.equal(v, b.model.state_dict()[k])
               for k, v in wa.items())


def test_an_f64_model_takes_the_f32_draw_cast():
    cfg = apply_overrides(lisec_tpu_torch.load_config(
        os.path.join(ROOT, "configs", "rangeseg_tiny.yaml")),
        ["model.params.dtype=float64"])
    f64 = lisec_tpu_torch.build_model(cfg, device="cpu")
    f32 = lisec_tpu_torch.build_model(lisec_tpu_torch.load_config(
        os.path.join(ROOT, "configs", "rangeseg_tiny.yaml")), device="cpu")
    f64.init_state(2)
    f32.init_state(2)
    for k, v in f32.model.state_dict().items():
        w = f64.model.state_dict()[k]
        assert torch.equal(w.to(v.dtype), v) and torch.equal(
            w, v.to(w.dtype)), k
