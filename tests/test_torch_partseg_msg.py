"""PointNet++ part segmentation with multi-scale grouping (``model.params.
msg: true``, ``configs/pointnet2_shapenetpart_msg.yaml``) against the JAX
package's, as a whole pipeline on ``pointnet2_partseg_tiny``.

MSG groups each set abstraction's centres at several radii (SA1 0.1 /
16, 0.2 / 32, 0.4 / 64 neighbours; SA2 0.4 / 64, 0.8 / 128), each scale
with its own shared MLP and BatchNorm statistics, and concatenates the
scales in radius order. At the 0.1 radius most centres of the tiny
fixture have few points in reach, so the ball query's repeat-fill of the
first index, and its gradient through the grouping's scatter, carry
weight.

Inputs are made from seeds and go through both packages on the CPU: the
port with ``device="cpu"``, where the kernels' wrappers run their plain
versions, the JAX package with its XLA gathers.
"""

import os
import types

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
from lisec_tpu_torch.weights import (
    convert_flax_arrays, load_weights_npz, to_flax_arrays)
from tests.dropout_masks import recorded_masks
from tests.test_torch_partseg import (  # noqa: F401
    _flat, _port_loss_and_grads, _rel, identity_dropout)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "pointnet2_partseg_tiny.yaml")
MSG = ["model.params.msg=true"]


@pytest.fixture(scope="module")
def jax_pipe():
    return lisec_tpu.build_model(
        jax_apply_overrides(jax_load_config(TINY), MSG))


@pytest.fixture(scope="module")
def port_pipe():
    return lisec_tpu_torch.build_model(
        lisec_tpu_torch.apply_overrides(lisec_tpu_torch.load_config(TINY),
                                        MSG), device="cpu")


@pytest.fixture(scope="module")
def tiny_state(jax_pipe, tmp_path_factory):
    """JAX's initial weights (``init_variables`` under ``jit``), its first
    unshuffled batch, and the same weights in an .npz for the port."""
    dummy = jax.tree.map(jnp.asarray, jax_pipe.dummy_batch())
    v = jax.jit(jax_pipe.init_variables)(jax.random.PRNGKey(0), dummy)
    state = types.SimpleNamespace(params=v["params"],
                                  batch_stats=v["batch_stats"])
    cfg = jax_pipe.cfg
    batch = next(jax_make_batches(
        jax_pipe.make_dataset("train"), cfg.budget, cfg.train.batch_size,
        shuffle=False))
    path = str(tmp_path_factory.mktemp("partseg_msg") / "init.npz")
    save_weights_npz(state, path)
    return state, batch, path


def test_weights_round_trip_every_msg_key(port_pipe, tiny_state):
    """Every flax key of the MSG network (three scales' shared MLPs in
    SA1, two in SA2, each with its BatchNorms: SSG's 88 and 45 more) maps
    to one port tensor and back, bit for bit."""
    _, _, path = tiny_state
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    state = convert_flax_arrays(flat)
    model = port_pipe.model
    assert len(state) == len(flat) == len(model.state_dict()) == 133
    load_weights_npz(model, path)
    back = to_flax_arrays(model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    scales = {k.split("/")[1]: set() for k in flat
              if k.split("/")[1].startswith("SetAbstraction_")}
    for k in flat:
        if k.split("/")[1] in scales:
            scales[k.split("/")[1]].add(k.split("/")[2])
    assert scales == {
        "SetAbstraction_0": {"SharedMLP_0", "SharedMLP_1", "SharedMLP_2"},
        "SetAbstraction_1": {"SharedMLP_0", "SharedMLP_1"}}
    # SA2's input: 3 + the three SA1 scales' 64 + 128 + 128 channels;
    # its second scale's widths 128, 196, 256.
    assert flat["params/SetAbstraction_1/SharedMLP_1/Dense_0/kernel"
                ].shape == (3 + 320, 128)
    assert state["sa.1.mlps.1.dense.1.weight"].shape == (196, 128)
    assert state["sa.1.mlps.1.bn.2.var"].shape == (256,)


def test_tiny_predict_matches_jax(jax_pipe, port_pipe, tiny_state):
    state, batch, path = tiny_state
    want = jax.device_get(jax_pipe.infer(state, batch))
    load_weights_npz(port_pipe.model, path)
    got = lisec_tpu_torch.infer(port_pipe, batch, device="cpu")
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"],
                               rtol=0,
                               atol=1e-4 * np.abs(want["logits"]).max())


@pytest.mark.parametrize("dropout", [False, True])
def test_pipeline_loss_and_gradients_match_jax(jax_pipe, port_pipe,
                                               tiny_state, request,
                                               monkeypatch, dropout):
    """Train-mode ``pipeline.loss`` of both packages from the same weights
    and batch: dropout the identity on both sides, or on at the JAX
    loop's key of step 0 with the mask bit-equal to flax's. The
    tolerances are SSG's (``tests/test_torch_partseg.py``)."""
    state, batch, path = tiny_state
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(0)
    if dropout:
        jax_masks, port_masks = recorded_masks(monkeypatch)
        rng = jax.random.fold_in(
            jax.random.PRNGKey(jax_pipe.cfg.train.seed + 17), 0)
    else:
        request.getfixturevalue("identity_dropout")

    @jax.jit
    def jax_loss_and_grad(params):
        out = jax.value_and_grad(
            lambda p: jax_pipe.loss(p, state.batch_stats, jbatch, rng,
                                    train=True), has_aux=True)(params)
        return out, (list(jax_masks) if dropout else [])
    ((want, (want_aux, new_bs)), grads), want_masks = jax_loss_and_grad(
        state.params)
    want_grads = _flat(grads, "params")
    key = port_pipe.step_key(0) if dropout else None
    # The share of SA2's 0.8-radius maxes over its 128 neighbours that are
    # not positive, from its last BatchNorm's output (before the ReLU).
    last_bn = port_pipe.model.sa[1].mlps[1].bn[2]
    shares = []
    hook = last_bn.register_forward_hook(lambda m, i, out: shares.append(
        float((out.amax(dim=-2) <= 0).float().mean())))
    try:
        total, aux, got_grads, got_state = _port_loss_and_grads(
            port_pipe, path, batch, key)
    finally:
        hook.remove()
    if dropout:
        assert len(want_masks) == len(port_masks) == 1
        np.testing.assert_array_equal(port_masks[0].numpy(),
                                      np.asarray(want_masks[0]))

    # f32 on both sides, the gathers exact on both: the loss to 1e-5, the
    # accuracy exactly, the running statistics of all five scales' MLPs
    # to 1e-4.
    np.testing.assert_allclose(total, float(want), rtol=1e-5)
    assert float(aux["acc"]) == float(want_aux["acc"])
    want_stats = _flat(new_bs, "batch_stats")
    assert sum(k.startswith("batch_stats/SetAbstraction_")
               for k in want_stats) == 5 * 3 * 2     # scales, BNs, mean/var
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_state[k], w, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert set(got_grads) == set(want_grads)
    assert len(want_grads) == len(list(port_pipe.model.parameters())) == 81
    gnorm = float(optax.global_norm(grads))
    np.testing.assert_allclose(
        np.sqrt(sum(float((g ** 2).sum()) for g in got_grads.values())),
        gnorm, rtol=1e-3)
    # As for SSG, two tensors have no gradient in exact arithmetic (each
    # feeds a train-mode BN that takes out a per-channel constant). MSG
    # adds a third: on these clouds every max over SA2's 128-neighbour
    # balls is positive, so the ReLU and the max pass its last bias on as
    # a per-channel constant, which the train-mode BNs after the global
    # set abstraction's and FP3's Dense layers take out. The rest lie
    # within 0.05 of each tensor's L2 norm (the BNs' f32 statistics summed
    # in other orders, amplified by the small net).
    assert shares == [0.0]
    zero = {"params/Dense_0/bias",
            "params/GlobalSetAbstraction_0/SharedMLP_0/BatchNorm_2/bias",
            "params/SetAbstraction_1/SharedMLP_1/BatchNorm_2/bias"}
    for k in zero:
        assert np.linalg.norm(want_grads[k]) < 1e-5 * gnorm, k
        assert np.linalg.norm(got_grads[k]) < 1e-5 * gnorm, k
    for k, w in want_grads.items():
        if k not in zero:
            assert _rel(got_grads[k], w) < 0.05, (k, _rel(got_grads[k], w))
