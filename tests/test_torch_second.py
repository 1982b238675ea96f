"""The port's SECOND (sparse middle encoder, net, pipeline, weights,
training) against the JAX package's.

Inputs are made with numpy from seeds and go through both packages on
the CPU: the port with ``device="cpu"``, where the kernels' wrappers run
their plain versions, the JAX package with its Pallas kernels in
interpret mode.
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
from lisec_tpu.config import load_config as jax_load_config
from lisec_tpu.data.collate import make_batches as jax_make_batches
from lisec_tpu.models.second import SparseMiddleEncoder as JaxEncoder
from lisec_tpu_torch.config import apply_overrides
from lisec_tpu_torch.models.second import SECONDNet, SparseMiddleEncoder
from lisec_tpu_torch.weights import (
    convert_flax_arrays, load_weights_npz, to_flax_arrays)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "second_tiny.yaml")


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, col, prefix=""):
    """A flax tree -> flat ``col/prefix/Module_0/.../leaf`` numpy dict."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[f"{col}/{prefix}" + "/".join(str(p.key) for p in path)] = \
            np.asarray(leaf)
    return out


# -- the middle encoder -------------------------------------------------------

GRID = (8, 16, 16)                 # (nz, ny, nx)
CHANNELS = (8, 16, 16)
BUDGETS = (64, 40, 24)             # the level-1 budget overflows on purpose


def _encoder_inputs(rng, b=2, n_active=(50, 33)):
    nz, ny, nx = GRID
    v = BUDGETS[0]
    coords = np.full((b, v, 3), -1, np.int32)
    feats = np.zeros((b, v, 4), np.float32)
    for i, n in enumerate(n_active):
        lins = np.sort(rng.choice(nz * ny * nx, n, replace=False))
        coords[i, :n] = np.stack([lins // (ny * nx), (lins // nx) % ny,
                                  lins % nx], -1)
        feats[i, :n] = rng.normal(size=(n, 4))
    return feats, coords, np.asarray(n_active, np.int32)


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


@pytest.mark.parametrize("downsample", ["dilate", "footprint"])
@pytest.mark.parametrize("dense_from", [1, 2, 4])     # 4: past the last
def test_middle_encoder_matches_flax(dense_from, downsample):
    rng = np.random.default_rng(10 * dense_from + len(downsample))
    feats, coords, num = _encoder_inputs(rng)
    jmodel = JaxEncoder(grid=GRID, channels=CHANNELS, level_budgets=BUDGETS,
                        subm_per_level=2, dense_from_level=dense_from,
                        downsample=downsample, dtype=jnp.float32)
    jargs = (jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(num))
    v = _randomize_bn(rng, jmodel.init(jax.random.PRNGKey(0), *jargs))
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}

    flat = {**_flat(v["params"], "params", "SparseMiddleEncoder_0/"),
            **_flat(v["batch_stats"], "batch_stats",
                    "SparseMiddleEncoder_0/")}
    state = {k[len("encoder."):]: t
             for k, t in convert_flax_arrays(flat).items()}
    # A net around the encoder, for to_flax_arrays' names.
    net = SECONDNet(1, GRID[::-1], 2, level_budgets=BUDGETS,
                    encoder_channels=CHANNELS, dense_from_level=dense_from,
                    downsample=downsample, bev_layers=(1,), bev_filters=(8,),
                    bev_strides=(1,), bev_up_strides=(1,),
                    bev_up_filters=(8,))
    port = net.encoder
    port.load_state_dict(state, strict=True)
    n_dense = {1: 5, 2: 2, 4: 0}[dense_from]
    assert len(port.dense) == n_dense and len(port.sparse) == 8 - n_dense

    # Inference mode. The JAX spread and paint route f32 values as two
    # bf16 terms (2^-17 relative per conv): 2e-4, the tolerance of the
    # JAX package's own dense-oracle test of this encoder.
    tol = dict(rtol=2e-4, atol=2e-4)
    want = np.asarray(jmodel.apply(v, *jargs, train=False))
    port.eval()
    with torch.no_grad():
        got = port(_t(feats), _t(coords), _t(num))
    assert got.shape == (2,) + (port.out_grid[0] * CHANNELS[-1],) \
        + port.out_grid[1:]
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, **tol)

    # Train mode: batch statistics (diluted by the padded rows in the
    # sparse layers, over active cells in the dense ones), the running
    # statistics after one step, and the gradients.
    wts = rng.normal(size=want.shape).astype(np.float32)

    def jax_loss(params, x):
        out, mut = jmodel.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, x,
            *jargs[1:], train=True, mutable=["batch_stats"])
        return jnp.sum(out * wts), (out, mut["batch_stats"])
    (_, (want_t, new_stats)), (gp, gx) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(v["params"], jargs[0])
    port.train()
    xt = _t(feats).requires_grad_()
    got_t = port(xt, _t(coords), _t(num))
    (got_t.permute(0, 2, 3, 1) * _t(wts)).sum().backward()
    np.testing.assert_allclose(got_t.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_t), **tol)

    got_state = to_flax_arrays(net)
    want_stats = _flat(new_stats, "batch_stats", "SparseMiddleEncoder_0/")
    old_stats = _flat(v["batch_stats"], "batch_stats",
                      "SparseMiddleEncoder_0/")
    assert len(want_stats) == 16
    for k, w in want_stats.items():
        assert not np.allclose(w, old_stats[k]), k
        np.testing.assert_allclose(got_state[k], w, rtol=2e-4, atol=1e-5,
                                   err_msg=k)
    # Gradients: each tensor within 1e-3 of its largest element (the
    # routing error passes through up to eight BatchNorm layers whose
    # statistics come from a few dozen rows).
    got_grads = to_flax_arrays(net, {
        "encoder." + n: p.grad for n, p in port.named_parameters()})
    want_grads = _flat(gp, "params", "SparseMiddleEncoder_0/")
    assert set(got_grads) == set(want_grads)
    for k, w in want_grads.items():
        np.testing.assert_allclose(
            got_grads[k], w, rtol=0, atol=1e-3 * np.abs(w).max() + 1e-7,
            err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0,
                               atol=1e-3 * np.abs(np.asarray(gx)).max())


def test_middle_encoder_bf16_runs_and_stays_close_to_f32():
    """The compute dtype is cast in per layer: bf16 parameters stay f32
    and the output is bf16, within bf16 rounding of the f32 encoder."""
    rng = np.random.default_rng(2)
    feats, coords, num = _encoder_inputs(rng)
    nets = [SparseMiddleEncoder(4, GRID, channels=CHANNELS,
                                level_budgets=BUDGETS, dense_from_level=2,
                                dtype=d)
            for d in (torch.float32, torch.bfloat16)]
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in nets[0].parameters():
            if p.dim() > 1:
                p.normal_(0.0, 0.15, generator=gen)
    nets[1].load_state_dict(nets[0].state_dict())
    outs = []
    for net in nets:
        net.eval()
        with torch.no_grad():
            outs.append(net(_t(feats), _t(coords), _t(num)))
    assert outs[1].dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in nets[1].parameters())
    # Eight layers of bf16 rounding (2^-8 each) on values of order 1.
    err = (outs[1].float() - outs[0]).abs().max()
    assert float(err) < 0.05 * float(outs[0].abs().max()), float(err)


# -- the slice as a whole on second_tiny -------------------------------------

@pytest.fixture(scope="module")
def jax_pipe():
    return lisec_tpu.build_model(jax_load_config(TINY))


@pytest.fixture(scope="module")
def port_pipe():
    return lisec_tpu_torch.build_model(lisec_tpu_torch.load_config(TINY),
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
    path = str(tmp_path_factory.mktemp("second") / "init.npz")
    save_weights_npz(state, path)
    return state, batch, path


def test_weights_round_trip_every_key(port_pipe, tiny_state):
    _, _, path = tiny_state
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    state = convert_flax_arrays(flat)
    model = port_pipe.model
    assert len(state) == len(flat) == len(model.state_dict()) == 101
    load_weights_npz(model, path)
    back = to_flax_arrays(model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    kinds = {k.split("/")[2].rstrip("0123456789") for k in flat
             if "SparseMiddleEncoder_0" in k}
    assert kinds == {"SparseConv3D_", "Conv_", "MaskedBatchNorm_"}
    # The dense tail's kernels change layout; the sparse ones do not.
    assert state["encoder.dense.0.weight"].shape == (32, 32, 3, 3, 3)
    assert state["encoder.sparse.0.weight"].shape == (27, 4, 8)
    with pytest.raises(KeyError):
        convert_flax_arrays({
            "params/SparseMiddleEncoder_0/Dense_0/kernel": flat[
                "params/SparseMiddleEncoder_0/SparseConv3D_0/kernel"]})


def test_tiny_predict_matches_golden_and_jax(jax_pipe, port_pipe,
                                             tiny_state):
    state, batch, path = tiny_state
    want = jax.device_get(jax_pipe.infer(state, batch))
    load_weights_npz(port_pipe.model, path)
    got = lisec_tpu_torch.infer(
        port_pipe, {k: batch[k] for k in ("points", "point_mask")},
        device="cpu")
    got = {k: v.numpy() for k, v in got.items()}
    # Keep sets and labels exactly.
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    # The golden's own tolerance (test_goldens.py::_check_or_regen).
    golden = np.load(os.path.join(ROOT, "tests", "goldens",
                                  "second_tiny.npz"))
    for k in ("boxes", "scores", "labels"):
        np.testing.assert_allclose(got[k], golden[k], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4)
    assert not port_pipe.model.training


def test_model_args_and_head_maps_match_jax(jax_pipe, port_pipe, tiny_state):
    """The voxelizer's integers exactly and the head maps of the eval
    forward, before any top-k or NMS decides anything."""
    state, batch, path = tiny_state
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_args = jax.device_get(jax_pipe._model_args(jbatch))
    load_weights_npz(port_pipe.model, path)
    got_args = port_pipe._model_args(port_pipe.device_batch(batch))
    for g, w in zip(got_args[1:], want_args[1:]):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_allclose(got_args[0].numpy(), want_args[0], rtol=1e-5,
                               atol=1e-6)
    want, _ = jax_pipe._forward(state.params, state.batch_stats, jbatch,
                                train=False)
    port_pipe.model.eval()
    with torch.no_grad():
        got = port_pipe.model(*got_args)
    for k in ("cls", "box", "dir"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


def _exact_spread(vals, targets, *, num_out, **_):
    """The JAX spread kernel's function as an exact f32 scatter-add:
    vals (B, K, C, N), targets (B, K, N) -> (B, num_out, C)."""
    b, k, c, _n = vals.shape
    out = jnp.zeros((b, num_out + 1, c), jnp.float32)
    rows = jnp.arange(b)[:, None]
    for kk in range(k):
        out = out.at[rows, jnp.clip(targets[:, kk], 0, num_out)].add(
            vals[:, kk].astype(jnp.float32).transpose(0, 2, 1))
    return out[:, :num_out]


@pytest.fixture
def exact_jax_routing(monkeypatch):
    """The JAX package with its routing error taken out, for this test
    only: the paint and unpaint kernels run with their own ``exact`` flag
    and the spread kernel is swapped for an exact scatter-add. Traces made
    before and under the patch are dropped."""
    from lisec_tpu.ops.pallas import pillar_paint, spread_kernel, unpaint
    paint, gather = pillar_paint.segment_paint, unpaint.segment_unpaint
    jax.clear_caches()
    monkeypatch.setattr(spread_kernel, "spread_accumulate", _exact_spread)
    monkeypatch.setattr(pillar_paint, "segment_paint",
                        lambda *a, **k: paint(*a, **{**k, "exact": True}))
    monkeypatch.setattr(unpaint, "segment_unpaint",
                        lambda *a, **k: gather(*a, **{**k, "exact": True}))
    yield
    jax.clear_caches()


@pytest.mark.parametrize("jax_routing", ["exact", "shipped"])
def test_pipeline_loss_and_gradients_match_jax(jax_pipe, port_pipe,
                                               tiny_state, request,
                                               jax_routing):
    """``pipeline.loss`` of both packages from the same weights and
    batch, against the JAX package as shipped and with its routing made
    exact (``exact_jax_routing``)."""
    if jax_routing == "exact":
        request.getfixturevalue("exact_jax_routing")
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

    # f32 on both sides; as shipped the JAX spread, paint and unpaint
    # route values as two bf16 terms (2^-17 relative): 1e-4 on the loss
    # and its terms either way.
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
    # Against exact routing every gradient lies within 2e-4 of its
    # tensor's L2 norm (measured 4e-5: f32 sums in another order). As
    # shipped, the routing error enters at the voxelizer's paint, at each
    # of the eight sparse convs forward and backward and at the densify,
    # and this small net amplifies it (batch statistics over a few dozen
    # rows and an 8x8 map, relu kinks): each tensor is held to 0.06 of
    # its own L2 norm (measured 0.027), beside the 1e-3 on the global norm.
    limit = 2e-4 if jax_routing == "exact" else 0.06
    for k, w in want_grads.items():
        rel = np.linalg.norm(got_grads[k] - w) / np.linalg.norm(w)
        assert rel < limit, (k, rel)
    got_state = to_flax_arrays(pipe.model)
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_state[k], w, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    moved = [k for k, w in _flat(state.batch_stats, "batch_stats").items()
             if not np.allclose(got_state[k], w)]
    assert len(moved) == len(want_stats)          # every BN layer moved


def test_train_lowers_loss_on_tiny():
    cfg = apply_overrides(lisec_tpu_torch.load_config(TINY), [
        "train.num_steps=40", "train.log_every=10", "data.fixture_size=8"])
    pipe, history = lisec_tpu_torch.train(cfg, device="cpu", progress=False)
    assert [h["step"] for h in history] == [1, 10, 20, 30, 40]
    assert all(np.isfinite(v) for h in history for v in h.values())
    assert history[-1]["loss"] < history[0]["loss"]
    assert all(h["num_pos"] > 0 for h in history)
    assert pipe.step == 40
    batch = next(lisec_tpu_torch.data.collate.make_batches(
        pipe.make_dataset("train"), cfg.budget, 2, shuffle=False))
    out = pipe.infer({k: batch[k] for k in ("points", "point_mask")})
    assert out["boxes"].shape == (2, cfg.budget.nms_post, 7)
    assert torch.isfinite(out["scores"]).all()


def test_second_is_registered_and_seed_initialised():
    from lisec_tpu_torch.registry import get_model, get_pipeline
    from lisec_tpu_torch.pipelines.detection import SECONDPipeline
    assert get_pipeline("second") is SECONDPipeline
    assert get_model("second") is SECONDNet
    cfg = lisec_tpu_torch.load_config(TINY)
    pipes = [SECONDPipeline(cfg, device="cpu", seed=s) for s in (0, 0, 1)]
    s0, s1, s2 = (p.model.state_dict() for p in pipes)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert not torch.equal(s0["encoder.sparse.0.weight"],
                           s2["encoder.sparse.0.weight"])
    # variance_scaling(2.0, fan_in): std = sqrt(2 / (27 * 8)) for the
    # second sparse conv (K = 27, Cin = 8).
    w = s0["encoder.sparse.1.weight"]
    assert w.shape == (27, 8, 8)
    np.testing.assert_allclose(float(w.std()), (2 / (27 * 8)) ** 0.5,
                               rtol=0.1)
    assert pipes[0].fmap == (8, 8) and pipes[0].anchors.shape == (128, 7)
