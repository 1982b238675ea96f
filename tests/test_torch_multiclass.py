"""The shipped multi-class PointPillars setup and the ``fast_encoder`` key
against the JAX package (the port's counterpart of
``tests/test_multiclass.py::test_three_class_pointpillars``).

Both packages run on the CPU from the JAX package's ``init_state(0)``
weights: the port with ``device="cpu"``, the JAX package with its
Pallas kernels in interpret mode.
"""

import os

import jax
import numpy as np
import pytest
import torch

import lisec_tpu
import lisec_tpu_torch
from lisec_tpu.bench_lib import save_weights_npz
from lisec_tpu.config import apply_overrides as jax_apply_overrides
from lisec_tpu.config import load_config as jax_load_config
from lisec_tpu.data.collate import make_batches
from lisec_tpu_torch.config import apply_overrides
from lisec_tpu_torch.weights import load_weights_npz

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "pointpillars_tiny.yaml")
THREE_CLASS = ["data.class_names=[Car,Pedestrian,Cyclist]",
               "model.params.eval_ap=true", "data.fixture_size=8"]


def _pipelines(overrides, tmp_path):
    """Both packages' pipelines of the tiny config with ``overrides``, the
    JAX state, the port on the same weights, and the first train batch."""
    jax_pipe = lisec_tpu.build_model(
        jax_apply_overrides(jax_load_config(TINY), overrides))
    state = jax_pipe.init_state(0)
    path = str(tmp_path / "init.npz")
    save_weights_npz(state, path)
    port = lisec_tpu_torch.build_model(
        apply_overrides(lisec_tpu_torch.load_config(TINY), overrides),
        device="cpu")
    port.init_state(0)
    load_weights_npz(port.model, path)
    cfg = jax_pipe.cfg
    batch = next(make_batches(jax_pipe.make_dataset("train"), cfg.budget,
                              cfg.train.batch_size, shuffle=False))
    return jax_pipe, state, port, batch


def _same_predict(got, want):
    """Keep sets and labels exactly, boxes and scores to 1e-4 (the
    tolerance of tests/test_torch_pointpillars.py)."""
    got = {k: v.numpy() for k, v in got.items()}
    want = jax.device_get(want)
    assert want["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    return got


def test_three_class_pointpillars_matches_jax(tmp_path):
    jax_pipe, state, port, batch = _pipelines(THREE_CLASS, tmp_path)
    # Anchors: feature-map cells x 3 classes x 2 rotations.
    ny, nx = port.fmap
    assert port.fmap == jax_pipe.fmap
    assert port.anchors.shape == (ny * nx * 6, 7)
    np.testing.assert_array_equal(port.anchors.numpy(),
                                  np.asarray(jax_pipe.anchors))
    np.testing.assert_array_equal(port.anchor_classes.numpy(),
                                  np.asarray(jax_pipe.anchor_classes))
    assert int(port.anchor_classes.max()) == 2

    points = {k: batch[k] for k in ("points", "point_mask")}
    got = _same_predict(port.infer(points), jax_pipe.infer(state, points))
    assert set(np.unique(got["labels"][got["valid"]])) <= {0, 1, 2}

    # Held-out metrics of the same weights: every class's AP bucket.
    want = jax_pipe.evaluate(state, max_batches=1)
    metrics = port.evaluate(max_batches=1)
    for c in range(3):
        assert f"class{c}_3d_ap_moderate" in metrics
    assert set(metrics) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(metrics[k], w, rtol=1e-5, atol=1e-6,
                                   err_msg=k)

    # One train step: its loss at tests/test_torch_train.py's tolerance.
    _, want_aux = jax_pipe.train_step(state, batch, jax.random.PRNGKey(0))
    aux = port.train_step(batch)
    assert np.isfinite(float(aux["loss"]))
    np.testing.assert_allclose(float(aux["loss"]), float(want_aux["loss"]),
                               rtol=1e-4)


@pytest.mark.parametrize("fast_encoder", ["false", "true"])
def test_predict_equals_jax_exact_encoder(tmp_path, fast_encoder):
    """The JAX ``fast_encoder: false`` runs its exact XLA encoder; the
    port's kernel computes that canvas, so the port's predict, under
    either value of the key, equals the JAX exact encoder's."""
    jax_pipe, state, _, batch = _pipelines(
        ["model.params.fast_encoder=false"], tmp_path)
    port = lisec_tpu_torch.build_model(
        apply_overrides(lisec_tpu_torch.load_config(TINY),
                        [f"model.params.fast_encoder={fast_encoder}"]),
        device="cpu")
    load_weights_npz(port.model, str(tmp_path / "init.npz"))
    points = {k: batch[k] for k in ("points", "point_mask")}
    _same_predict(port.infer(points), jax_pipe.infer(state, points))
