"""SECOND with the footprint downsample (``model.params.downsample:
footprint``, the JAX package's benchmarked SECOND) against the JAX
package's, as a whole pipeline on ``second_tiny``.

Each strided conv of this encoder keeps only the output cells whose
2x2x2 input footprint is occupied (``ops/sparse_conv.py::
build_footprint_coords``), so its rulebook is much sparser than the
dilate model's. The cases run the encoder's dense tail from level 2 (the
footprint max-pool of ``_pool_active`` runs) and from level 3 (as the
shipped configs), and with budgets that every downsampled level
overflows, where both packages keep the lowest cell ids.

Inputs are made from seeds and go through both packages on the CPU: the
port with ``device="cpu"``, where the kernels' wrappers run their plain
versions, the JAX package with its Pallas kernels in interpret mode.
"""

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
from lisec_tpu.ops import sparse_conv as jax_sparse_conv
from lisec_tpu_torch.models.second import _down_spec
from lisec_tpu_torch.ops.sparse_conv import build_footprint_coords
from lisec_tpu_torch.weights import load_weights_npz, to_flax_arrays
from tests.test_torch_second import _flat, exact_jax_routing  # noqa: F401

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "second_tiny.yaml")

# The tiny fixture's first batch fills the level-0 budget (1,024 voxels a
# cloud); under the footprint downsample its levels 1-3 hold 481 / 463,
# 168 / 169 and 54 / 54 cells, inside second_tiny's budgets
# (768, 384, 192). The "overflow" budgets cut every level: 384 of level
# 1's cells, then 96 of the 124 those give at level 2, then 24 of 26 / 25.
CASES = {
    "dense_from_2": ["model.params.dense_from_level=2"],
    "dense_from_3": ["model.params.dense_from_level=3"],
    "overflow": ["model.params.dense_from_level=3",
                 "model.params.level_budgets=[1024,384,96,24]"],
}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Per case: both pipelines, JAX ``init_state(0)``, the first
    unshuffled batch and the same weights in an .npz for the port."""
    cache = {}

    def get(case):
        if case not in cache:
            overrides = ["model.params.downsample=footprint", *CASES[case]]
            jax_pipe = lisec_tpu.build_model(
                jax_apply_overrides(jax_load_config(TINY), overrides))
            port_pipe = lisec_tpu_torch.build_model(
                lisec_tpu_torch.apply_overrides(
                    lisec_tpu_torch.load_config(TINY), overrides),
                device="cpu")
            state = jax_pipe.init_state(0)
            cfg = jax_pipe.cfg
            batch = next(jax_make_batches(
                jax_pipe.make_dataset("train"), cfg.budget,
                cfg.train.batch_size, shuffle=False))
            path = str(tmp_path_factory.mktemp(case) / "init.npz")
            save_weights_npz(state, path)
            load_weights_npz(port_pipe.model, path)
            cache[case] = (jax_pipe, port_pipe, state, batch)
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_level_sets_match_jax(built, case):
    """The voxelizer's integers and every level's footprint set (cell
    coordinates and counts, the truncation included) equal the JAX
    package's exactly."""
    jax_pipe, port_pipe, _, batch = built(case)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_args = jax.device_get(jax_pipe._model_args(jbatch))
    got_args = port_pipe._model_args(port_pipe.device_batch(batch))
    for g, w in zip(got_args[1:], want_args[1:]):
        np.testing.assert_array_equal(g.numpy(), w)

    encoder = port_pipe.model.encoder
    assert encoder.downsample == "footprint"
    coords, num = got_args[1], got_args[-1]
    grid = encoder.grid
    truncated = []
    for level in range(1, len(encoder.channels)):
        spec = _down_spec(grid)
        budget = encoder.level_budgets[level]
        got_c, got_n = build_footprint_coords(coords, num, spec,
                                              max_out=budget)
        want_c, want_n = jax.vmap(
            lambda c, n, spec=spec, budget=budget:
            jax_sparse_conv.build_footprint_coords(
                c, n, jax_sparse_conv.SparseConvSpec(
                    spec.kernel_size, spec.stride, spec.padding,
                    spec.grid_in), max_out=budget))(
            jnp.asarray(coords.numpy()), jnp.asarray(num.numpy()))
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        _, untruncated = build_footprint_coords(coords, num, spec,
                                                max_out=coords.shape[1])
        assert bool((untruncated <= num).all())     # the set never grows
        truncated.append(bool((untruncated > budget).any()))
        coords, num, grid = got_c, got_n, spec.grid_out
    assert truncated == ([True] * 3 if case == "overflow" else [False] * 3)


@pytest.mark.parametrize("jax_routing", ["exact", "shipped"])
@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_loss_and_gradients_match_jax(built, request, case,
                                               jax_routing):
    """``pipeline.loss`` and every gradient of both packages from the
    same weights and batch, at the dilate model's tolerances
    (``tests/test_torch_second.py``)."""
    if jax_routing == "exact":
        request.getfixturevalue("exact_jax_routing")
    jax_pipe, pipe, state, batch = built(case)
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

    before = {k: v.clone() for k, v in pipe.model.state_dict().items()}
    pipe.model.train()
    pipe.model.zero_grad()
    total, aux = pipe.loss(pipe.device_batch(batch))
    total.backward()
    pipe.model.eval()
    got_state = {k: np.array(v)
                 for k, v in to_flax_arrays(pipe.model).items()}
    pipe.model.load_state_dict(before)        # the next case's weights

    # f32 on both sides: 1e-4 on the loss and its terms.
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
    # Each gradient within 2e-4 of its tensor's L2 norm against exact
    # routing, 0.06 against the JAX package as shipped (its paint, spread
    # and unpaint route f32 values as two bf16 terms), as for dilate.
    limit = 2e-4 if jax_routing == "exact" else 0.06
    for k, w in want_grads.items():
        rel = np.linalg.norm(got_grads[k] - w) / np.linalg.norm(w)
        assert rel < limit, (k, rel)
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_state[k], w, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    moved = [k for k, w in _flat(state.batch_stats, "batch_stats").items()
             if not np.allclose(got_state[k], w)]
    assert len(moved) == len(want_stats)          # every BN layer moved
