"""The port's data parallelism (``lisec_tpu_torch/parallel``,
``Pipeline.forward_backward`` / ``train_step`` / ``infer_dp`` on a mesh,
``train`` on several ranks) against its single-device program and the
JAX package's 8-device mesh.

The ranks are gloo processes on the CPU that meet through a ``file://``
rendezvous in a temporary directory (``parallel.run_ranks``), one group a
model. Inputs come from seeds. The rank functions import nothing of JAX;
the JAX side runs in the test process on ``tests/conftest.py``'s 8
virtual CPU devices.

Tolerances. Where the model runs in float64 (PointNet, range-seg), DP
gradients are held to ``tests/test_dp.py``'s 2e-4 / 1e-6 elementwise
and a train step to its ``close_enough`` rule. In float32 the port's
single-device gradients are not stable to that level: the same batch in
another row order (a different order of the same f32 sums) already
moves them by up to 5e-3 of a tensor's L2 norm on ``pointpillars_tiny``
(batch statistics over a 4x4 map, relu kinks; see
``tests/test_torch_train.py``), and Adam's first step then moves the
elements whose gradient changed sign by 2 lr. So in float32 each
gradient tensor is held to 4 times that spread, measured here on four
other row orders with dropout the identity (two orders alone can fall
close together and understate it), plus ``test_dp.py``'s rtol, and the
step's sign flips to 4 times theirs; a
rank that kept its own BatchNorm statistics, loss denominator, Lovász
sort or dropout draw misses that by orders of magnitude. A tensor's
differences are taken relative to its L2 norm, or to 1e-3 of all the
gradients' norm where its own is smaller, so that a tensor whose gradient
is near zero is not held at a relative allowance of order 1. Each DP
check also runs on the planted faults of ``chip_smoke.PLANTED_FAULTS``
(per-rank BatchNorm statistics, rank-local sums, a rank-local Lovász
term) and must fail them.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import lisec_tpu_torch as lt
from chip_smoke import planted_fault
from lisec_tpu_torch.config import apply_overrides
from lisec_tpu_torch.data.collate import make_batches
from lisec_tpu_torch.parallel import (
    Mesh, ProcessShardDataset, all_gather, current_mesh, global_mean,
    global_sum, initialize_distributed, make_mesh, run_ranks, shard_batch,
    use_mesh)
from lisec_tpu_torch.weights import load_weights_npz

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
CLS = "configs/pointnet_modelnet40_tiny.yaml"
PP = "configs/pointpillars_tiny.yaml"
SECOND = "configs/second_tiny.yaml"
PARTSEG = "configs/pointnet2_partseg_tiny.yaml"
RANGESEG = "configs/rangeseg_tiny.yaml"
TINY_CONFIGS = [CLS, PP, SECOND, PARTSEG, RANGESEG]
# The planted faults (``chip_smoke.PLANTED_FAULTS``: a global reduction
# made rank-local, as plain DDP has it) that change each config's
# gradients at batch 8 on 4 ranks and that its DP check must fail.
FAULTS = {
    CLS: ("local_batch_norm",),
    PP: ("local_batch_norm", "local_sums"),
    SECOND: ("local_batch_norm", "local_sums"),
    PARTSEG: ("local_batch_norm", "local_sums"),
    RANGESEG: ("local_batch_norm", "local_sums", "local_lovasz"),
}


def _uneven(batch):
    """``batch`` with its clouds made unlike where the fixture makes them
    alike: detector cloud i keeps its first 1 + i % 5 boxes, and part-seg
    cloud i leaves its last 64 (i % 4) points unlabelled (-1), so that the
    ranks' rows hold different numbers of positives and of labelled points
    (a rank that took its own count for the global batch's would get
    another loss)."""
    batch = dict(batch)
    if "gt_mask" in batch:
        n, m = batch["gt_mask"].shape
        keep = 1 + np.arange(n) % 5
        batch["gt_mask"] = batch["gt_mask"] & (np.arange(m) < keep[:, None])
    if "point_labels" in batch and "category" in batch:
        labels = batch["point_labels"].copy()
        n, m = labels.shape
        labels[np.arange(m) >= m - 64 * (np.arange(n) % 4)[:, None]] = -1
        batch["point_labels"] = labels
    return batch


def _setup(path, overrides=(), num_devices=1, f64=False):
    """A pipeline from ``init_state(0)`` and its config's first unshuffled
    batch (``_uneven``)."""
    torch.set_num_threads(1)
    cfg = apply_overrides(lt.load_config(os.path.join(ROOT, path)),
                          [f"train.num_devices={num_devices}", *overrides])
    pipe = lt.build_model(cfg, device="cpu")
    pipe.init_state(0)
    batch = _uneven(next(make_batches(pipe.make_dataset("train"),
                                      cfg.budget, cfg.train.batch_size,
                                      shuffle=False)))
    if f64:
        pipe.model.double()
    if f64 and path == CLS:
        # Range-seg's projection takes the f32 points, and its network
        # casts the image to the model's type.
        batch = {k: v.astype(np.float64) if v.dtype.kind == "f" else v
                 for k, v in batch.items()}
    return pipe, batch


def _grads(pipe, batch):
    """(aux floats, {name: gradient}) of one ``forward_backward``."""
    pipe.model.zero_grad(set_to_none=True)
    aux = pipe.forward_backward(batch)
    return ({k: float(v) for k, v in aux.items()},
            {n: p.grad.clone() for n, p in pipe.model.named_parameters()
             if p.grad is not None})


def _step(pipe, batch):
    aux = pipe.train_step(batch)
    return ({k: float(v) for k, v in aux.items()},
            {k: v.clone() for k, v in pipe.model.state_dict().items()})


def _rank_model(path, overrides, f64, weights=None, infer_keys=()):
    """One rank of a DP group: the gradients, then a train step; the
    gradients under each of the config's planted faults, from ``init_state``
    again; then (with ``weights``) ``infer_dp`` of the batch's
    ``infer_keys`` and the gradients from those weights in float32."""
    pipe, batch = _setup(path, overrides, WORLD, f64)
    out = {"grads": _grads(pipe, batch), "step": _step(pipe, batch),
           "faults": {}}
    for fault in FAULTS[path]:
        pipe, batch = _setup(path, overrides, WORLD, f64)
        with planted_fault(fault):
            out["faults"][fault] = _grads(pipe, batch)[1]
    if weights:
        pipe, batch = _setup(path, overrides, WORLD)
        load_weights_npz(pipe.model, weights)
        out["infer_dp"] = pipe.infer_dp({k: batch[k] for k in infer_keys})
        out["jax_weights"] = _grads(pipe, batch)
    return out


def _check_grads(got, want, spread, rtol, atol):
    """``got`` against ``want``: elementwise at (rtol, atol) without
    ``spread``; else each tensor (and all of them together) within 4
    times the spread of the single-device gradients over row orders
    (``_spread``), plus rtol, both relative to the tensor's L2 norm or
    to 1e-3 of all of them together, whichever is larger."""
    assert set(got) == set(want)
    if not spread:
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=rtol, atol=atol, err_msg=k)
        return
    (base, *others) = [s[0] for s in spread]

    def flat(g):
        return {"all": torch.cat([g[k].reshape(-1) for k in sorted(want)])}
    floor = 1e-3 * float(flat(want)["all"].double().norm())
    for pick in (lambda g: g, flat):
        b = pick(base)
        for k, v in pick(want).items():
            scale = max(float(v.double().norm()), floor)
            noise = max(_dist(pick(o)[k], b[k]) for o in others) / scale
            err = _dist(pick(got)[k], v) / scale
            assert err <= 4 * noise + rtol, (k, err, noise)


def _dist(a, b):
    return float((a.double() - b.double()).norm())


def _check_faults_fail(ranks, want, spread, rtol, atol):
    """Every planted fault's gradients fail ``_check_grads``."""
    for fault, got in ranks[0]["faults"].items():
        try:
            _check_grads(got, want, spread, rtol, atol)
        except AssertionError:
            continue
        pytest.fail(f"the planted fault {fault} passes the DP check")


def _no_dropout(pipe):
    for m in pipe.model.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0


def _spread(path, overrides=()):
    """The single-device program's (gradients, state after a train step,
    its metrics) on its batch and on four other row orders of it, dropout
    the identity (another order would move the masks): how far f32 sums
    in another order move them."""
    out = []
    for seed in (None, 0, 1, 2, 3):
        pipe, batch = _setup(path, overrides)
        _no_dropout(pipe)
        if seed is not None:
            perm = np.random.default_rng(seed).permutation(
                len(batch["points"]))
            batch = {k: v[perm] for k, v in batch.items()}
        out.append((_grads(pipe, batch)[1], *_step(pipe, batch)[::-1]))
    return out


def _pooled_off(a, b):
    """The share of all floating elements of two states more than 1e-3
    apart."""
    keys = [k for k, v in b.items() if v.is_floating_point()]
    return float(np.mean(np.concatenate([
        np.abs(np.asarray(a[k]) - np.asarray(b[k])).reshape(-1) > 1e-3
        for k in keys])))


def close_enough(a, b, lr):
    """``tests/test_dp.py``'s rule for parameters after Adam steps: Adam
    moves an element by the learning rate whatever its gradient's size,
    so an element whose gradient changes sign under another order of f32
    sums moves the other way; below 1e-4 of the elements may differ by
    over 1e-3, and none by more than 2 lr."""
    a, b = np.asarray(a), np.asarray(b)
    diff = np.abs(a - b)
    frac_off = np.mean(diff > 1e-3)
    assert frac_off < 1e-4, f"{frac_off:.2%} elements differ"
    assert diff.max() <= 2 * lr + 1e-4, diff.max()


def _check_step(ranks, want, lr, rtol, spread=()):
    """Rank 0's train step against one device's: ``close_enough`` on each
    tensor; with ``spread`` (``_spread``) instead as many sign flips over
    the whole state as the other row orders give, 4 times over, beside
    the rule's 1e-4 (a tensor of a few hundred elements holds one or none
    at random), every element within 2 lr, and the metrics within ``rtol``
    plus 4 times their spread."""
    (aux, state), (want_aux, want_state) = ranks[0]["step"], want
    base, others = (spread[0], spread[1:]) if spread else (None, [])
    for k in want_aux:
        noise = max([abs(o[2][k] - base[2][k]) / abs(base[2][k])
                     for o in others if base[2][k]] or [0.0])
        np.testing.assert_allclose(aux[k], want_aux[k],
                                   rtol=rtol + 4 * noise, atol=1e-7,
                                   err_msg=k)
    for k, v in want_state.items():
        # Every rank holds the same parameters and running statistics.
        assert all(torch.equal(r["step"][1][k], state[k])
                   for r in ranks[1:]), k
        if not v.is_floating_point():
            assert torch.equal(state[k], v), k
        elif not spread:
            close_enough(state[k], v, lr)
        else:
            assert float((state[k] - v).abs().max()) <= 2 * lr + 1e-4, k
    if spread:
        flips = max(_pooled_off(o[1], base[1]) for o in others)
        assert _pooled_off(state, want_state) < 4 * flips + 1e-4, flips


# -- the pieces ---------------------------------------------------------------

def test_process_shard_dataset_partitions_as_jax():
    from lisec_tpu.parallel import ProcessShardDataset as JaxShard
    data = list(range(103))
    for p in range(4):
        got = ProcessShardDataset(data, process_id=p, process_count=4)
        want = JaxShard(data, process_id=p, process_count=4)
        assert len(got) == len(want) == 103 // 4
        assert [got[i] for i in range(len(got))] == \
            [want[i] for i in range(len(want))]
    # Without a group: the whole dataset, as one JAX process sees it.
    assert len(ProcessShardDataset(data)) == 103


def test_initialize_distributed_without_environment_returns_false(
        monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        initialize_distributed("localhost:1", process_id=0, device="cpu")


def test_shard_batch_returns_the_rank_rows():
    batch = {"points": np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
             "label": np.arange(8)}
    for r in range(4):
        got = shard_batch(batch, Mesh(world=4, rank=r, device="cpu"))
        assert got["points"].tolist() == batch["points"][2 * r:2 * r + 2
                                                         ].tolist()
        assert got["label"].tolist() == [2 * r, 2 * r + 1]
    local = shard_batch(batch, Mesh(world=4, rank=1, device="cpu",
                                    process_local=True))
    assert local["label"].tolist() == list(range(8))
    with pytest.raises(ValueError, match="split"):
        shard_batch({"label": np.arange(6)}, Mesh(world=4, device="cpu"))


def test_mesh_without_a_group():
    assert make_mesh(0, "cpu").world == make_mesh(1, "cpu").world == 1
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh(4, "cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        lt.build_model(apply_overrides(lt.load_config(
            os.path.join(ROOT, CLS)), ["train.num_devices=2"]), device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_entry_points_default_to_the_card():
    """Without a card the mesh, the local ranks and the dry run raise
    unless the caller asks for the CPU, as ``build_model`` does."""
    from lisec_tpu_torch.parallel.dryrun import dryrun_multichip
    for call in (make_mesh, lambda: run_ranks(_rank_model, 2),
                 lambda: dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


def test_world_one_helpers_return_their_argument():
    x = torch.arange(6.0).reshape(2, 3)
    assert current_mesh().world == 1
    with use_mesh(make_mesh(1, "cpu")):
        assert global_sum(x) is x and all_gather(x) is x
        [mean] = global_mean([x], (0,))
        assert torch.equal(mean, x.mean(dim=(0,)))


@pytest.mark.parametrize("path", TINY_CONFIGS)
def test_world_one_is_the_single_device_program(path):
    """At world 1 ``forward_backward`` is the pipeline's loss and its
    backward with no mesh, bit for bit."""
    pipe, batch = _setup(path)
    aux, grads = _grads(pipe, batch)
    stats = {k: v.clone() for k, v in pipe.model.state_dict().items()}
    pipe, batch = _setup(path)
    pipe.model.train()
    loss, want_aux = pipe.loss(pipe.device_batch(batch))
    loss.backward()
    assert aux["loss"] == float(loss.detach())
    for k, v in want_aux.items():
        assert aux[k] == float(v), k
    for n, p in pipe.model.named_parameters():
        if p.grad is not None:
            assert torch.equal(grads[n], p.grad), n
    for k, v in pipe.model.state_dict().items():
        assert torch.equal(stats[k], v), k


# -- DP against one device ----------------------------------------------------

def _jax_cls_grads(path):
    """The JAX package's PointNet gradients on its 8-device mesh
    (``test_dp.py::_dp_grads_check``'s recipe, dropout the identity), its
    weights saved to ``path``, and its batch."""
    import flax.linen
    import jax
    import jax.numpy as jnp
    import types
    import lisec_tpu
    import lisec_tpu.models.common as jax_common
    from lisec_tpu.bench_lib import save_weights_npz
    from lisec_tpu.config import load_config as jax_load_config
    from lisec_tpu.data.collate import make_batches as jax_make_batches
    from lisec_tpu.parallel import batch_sharding, replicated_sharding

    nn = types.SimpleNamespace(**{k: getattr(flax.linen, k)
                                  for k in dir(flax.linen)})
    nn.Dropout = lambda rate, deterministic=None: (lambda x: x)
    saved = jax_common.nn
    jax_common.nn = nn
    try:
        cfg = jax_load_config(os.path.join(ROOT, CLS))
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, num_devices=8))
        pipe = lisec_tpu.build_model(cfg)
        state = pipe.init_state(0)
        batch = next(jax_make_batches(pipe.make_dataset("train"),
                                      cfg.budget, 16, shuffle=False))
        params = jax.device_put(state.params,
                                replicated_sharding(pipe.mesh))
        sharded = jax.tree.map(lambda x: jax.device_put(
            jnp.asarray(x), batch_sharding(pipe.mesh)), batch)
        (_, _), grads = jax.jit(jax.value_and_grad(
            lambda p: pipe.loss(p, state.batch_stats, sharded,
                                jax.random.PRNGKey(3), train=True),
            has_aux=True))(params)
    finally:
        jax_common.nn = saved
    save_weights_npz(state, path)
    out = {}
    for p, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out["params/" + "/".join(str(k.key) for k in p)] = np.asarray(leaf)
    return out, batch


def _rank_cls(weights):
    f64 = _rank_model(CLS, (), True)
    pipe, batch = _setup(CLS, (), WORLD)
    load_weights_npz(pipe.model, weights)
    pipe.model.head.dropout_rate = 0.0
    return {**f64, "jax_weights": _grads(pipe, batch)}


def test_dp_pointnet_equals_one_device_and_the_jax_mesh(tmp_path):
    """4 ranks at batch 16: in float64 with dropout on (each rank keeps
    its rows of the global batch's masks), the gradients at
    ``test_dp.py``'s tolerances and a train step by its ``close_enough``
    rule; in float32 with dropout off from the JAX package's weights,
    the gradients against its 8-device mesh at ``test_torch_cls.py``'s
    tolerances."""
    from lisec_tpu_torch.weights import to_flax_arrays
    weights = str(tmp_path / "w.npz")
    jax_grads, jax_batch = _jax_cls_grads(weights)
    ranks = run_ranks(_rank_cls, WORLD, weights, device="cpu")

    pipe, batch = _setup(CLS, f64=True)
    want_aux, want = _grads(pipe, batch)
    aux, got = ranks[0]["grads"]
    np.testing.assert_allclose(aux["loss"], want_aux["loss"], rtol=1e-12)
    assert aux["acc"] == want_aux["acc"]
    _check_grads(got, want, None, rtol=2e-4, atol=1e-6)
    _check_faults_fail(ranks, want, None, rtol=2e-4, atol=1e-6)
    for r in ranks[1:]:
        assert all(torch.equal(r["grads"][1][k], got[k]) for k in got)
    _check_step(ranks, _step(pipe, batch), lr=0.002, rtol=1e-10)

    for k, v in batch.items():
        np.testing.assert_array_equal(v if v.dtype.kind != "f" else
                                      v.astype(np.float32), jax_batch[k])
    port = lt.build_model(lt.load_config(os.path.join(ROOT, CLS)),
                          device="cpu").model
    got = to_flax_arrays(port, ranks[0]["jax_weights"][1])
    assert set(got) == set(jax_grads)
    gnorm = np.sqrt(sum(float((g ** 2).sum()) for g in jax_grads.values()))
    for k, w in jax_grads.items():
        if np.linalg.norm(w) < 1e-6 * gnorm:
            assert np.linalg.norm(got[k]) < 1e-5 * gnorm, k
            continue
        rel = np.linalg.norm(got[k] - w) / np.linalg.norm(w)
        assert rel < 0.05, (k, rel)


def _jax_pointpillars_mesh(path):
    """The JAX package's ``infer_dp`` of pointpillars_tiny on its 8-device
    mesh at batch 8 and its gradients there (``test_dp.py``'s
    ``_dp_grads_check`` recipe, its default Pallas train path), from its
    ``init_state(0)`` weights, saved to ``path``; and its batch."""
    import jax
    import jax.numpy as jnp
    import lisec_tpu
    from lisec_tpu.parallel import batch_sharding, replicated_sharding
    from lisec_tpu.bench_lib import save_weights_npz
    from lisec_tpu.config import apply_overrides as jax_apply_overrides
    from lisec_tpu.config import load_config as jax_load_config
    from lisec_tpu.data.collate import make_batches as jax_make_batches
    cfg = jax_apply_overrides(jax_load_config(os.path.join(ROOT, PP)),
                              ["train.num_devices=8",
                               "train.batch_size=8"])
    pipe = lisec_tpu.build_model(cfg)
    state = pipe.init_state(0)
    batch = _uneven(next(jax_make_batches(pipe.make_dataset("train"),
                                          cfg.budget, 8, shuffle=False)))
    save_weights_npz(state, path)
    out = pipe.infer_dp(state, {k: batch[k] for k in ("points",
                                                      "point_mask")})
    params = jax.device_put(state.params, replicated_sharding(pipe.mesh))
    sharded = jax.tree.map(lambda x: jax.device_put(
        jnp.asarray(x), batch_sharding(pipe.mesh)), batch)
    (_, _), grads = jax.jit(jax.value_and_grad(
        lambda p: pipe.loss(p, state.batch_stats, sharded,
                            jax.random.PRNGKey(3), train=True),
        has_aux=True))(params)
    flat = {"params/" + "/".join(str(k.key) for k in p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return ({k: np.asarray(v) for k, v in jax.device_get(out).items()},
            flat, batch)


def _check_jax_grads(ranks, model, jax_grads, batch, jax_batch):
    """Rank 0's gradients from the JAX package's weights against its
    8-device mesh's: the global norm within 1e-3 and each tensor within
    0.10 of its L2 norm (``test_torch_train.py``'s tolerances against the
    JAX Pallas train path, whose bf16 terms move this small net's
    gradients by up to 5% of a tensor)."""
    from lisec_tpu_torch.weights import to_flax_arrays
    for k, v in batch.items():
        np.testing.assert_array_equal(v, jax_batch[k], err_msg=k)
    got = to_flax_arrays(model, ranks[0]["jax_weights"][1])
    assert set(got) == set(jax_grads)
    np.testing.assert_allclose(
        np.sqrt(sum(float((g ** 2).sum()) for g in got.values())),
        np.sqrt(sum(float((g ** 2).sum()) for g in jax_grads.values())),
        rtol=1e-3)
    for k, w in jax_grads.items():
        rel = np.linalg.norm(got[k] - w) / np.linalg.norm(w)
        assert rel < 0.10, (k, rel)


def _same_boxes(got, want):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("path,f64", [
    (PP, False), (SECOND, False), (PARTSEG, False), (RANGESEG, False),
    (RANGESEG, True)])
def test_dp_gradients_and_step_equal_one_device(path, f64, tmp_path):
    """4 ranks at batch 8: the gradients, the loss and its metrics and a
    train step against the single-device program on the same batch (the
    detectors through the paint, spread and unpaint kernels' plain
    versions, part-seg through FPS, the gathers and the scatter, range-seg
    with its global cross-entropy denominator and Lovász sort, also in
    float64 at ``test_dp.py``'s tolerances); for PointPillars also
    ``infer_dp`` against ``infer`` and the JAX package's mesh."""
    over = ("train.batch_size=8",
            *(("model.params.dtype=float64",) if f64 else ()))
    weights = infer_keys = None
    if path == PP:
        weights = str(tmp_path / "w.npz")
        jax_out, jax_grads, jax_batch = _jax_pointpillars_mesh(weights)
        infer_keys = ("points", "point_mask")
    ranks = run_ranks(_rank_model, WORLD, path, over, f64, weights,
                      infer_keys, device="cpu")

    pipe, batch = _setup(path, over, f64=f64)
    want_aux, want = _grads(pipe, batch)
    aux, got = ranks[0]["grads"]
    assert set(aux) == set(want_aux)
    for k in want_aux:
        np.testing.assert_allclose(aux[k], want_aux[k],
                                   rtol=1e-10 if f64 else 5e-4, atol=1e-7,
                                   err_msg=k)
    spread = () if f64 else _spread(path, over)
    _check_grads(got, want, spread, rtol=5e-4, atol=5e-6)
    _check_faults_fail(ranks, want, spread, rtol=5e-4, atol=5e-6)
    for r in ranks[1:]:
        assert all(torch.equal(r["grads"][1][k], got[k]) for k in got)
    _check_step(ranks, _step(pipe, batch), lr=0.002,
                rtol=1e-10 if f64 else 5e-4, spread=spread)

    if path == PP:
        _check_jax_grads(ranks, pipe.model, jax_grads, batch, jax_batch)
        load_weights_npz(pipe.model, weights)
        want = {k: v.numpy() for k, v in pipe.infer(
            {k: batch[k] for k in infer_keys}).items()}
        assert want["valid"].sum() > 0
        for r in ranks:
            got = {k: v.numpy() for k, v in r["infer_dp"].items()}
            assert {k: v.dtype for k, v in got.items()} == \
                {k: v.dtype for k, v in want.items()}
            _same_boxes(got, want)
            _same_boxes(got, jax_out)


def test_dryrun_multichip(capsys):
    from lisec_tpu_torch.parallel.dryrun import dryrun_multichip
    loss = dryrun_multichip(4, device="cpu")
    assert np.isfinite(loss)
    assert f"dryrun_multichip(4): ok, loss={loss:.4f}" in \
        capsys.readouterr().out


# -- train() on two ranks -----------------------------------------------------

# SGD: Adam moves every element by the learning rate whatever the size
# of its gradient, so after the first step the f32 noise of another order
# of sums (elements whose gradient is near 0 change sign) sets the two
# runs apart by 2 lr in those elements (test_dp.py's close_enough), and
# the later steps' gradient norms by 1e-3. SGD keeps them within that
# noise; Adam's DP step is held in the tests above.
TRAIN = ["train.num_steps=3", "train.log_every=1", "train.ckpt_every=1",
         "train.ckpt_keep=10", "train.eval_every=0", "train.optimizer=sgd"]


def _train_cfg(num_devices, ckpt_dir, *extra):
    return apply_overrides(lt.load_config(os.path.join(ROOT, CLS)), [
        *TRAIN, f"train.num_devices={num_devices}",
        f"train.ckpt_dir={ckpt_dir}", *extra])


def _rank_train(root):
    """3 steps, a resume to 5, and an unbroken run of 5, on the group;
    with the checkpoint files each rank wrote."""
    from lisec_tpu_torch.training.checkpoint import CheckpointManager
    torch.set_num_threads(1)
    writes = []
    write = CheckpointManager._write

    def counted(self, step, pipeline):
        writes.append(step)
        write(self, step, pipeline)
    CheckpointManager._write = counted
    w = torch.distributed.get_world_size()
    a = os.path.join(root, "a")
    out = {"three": lt.train(_train_cfg(w, a), device="cpu",
                             progress=False)[1]}
    out["resumed"] = lt.train(_train_cfg(w, a, "train.num_steps=5",
                                         "train.resume=auto"),
                              device="cpu", progress=False)[1]
    pipe, out["five"] = lt.train(_train_cfg(
        0, os.path.join(root, "c"), "train.num_steps=5"), device="cpu",
        progress=False)
    out["state"] = pipe.model.state_dict()
    out["writes"] = writes
    return out


def test_train_on_two_ranks(tmp_path):
    """``train`` on 2 ranks: its loss history that of one device on the
    same batches; rank 0 alone writes the checkpoints and
    ``metrics.jsonl``; a resume continues exactly as the unbroken run."""
    ranks = run_ranks(_rank_train, 2, str(tmp_path), device="cpu")
    _, want = lt.train(_train_cfg(1, str(tmp_path / "one")), device="cpu",
                       progress=False)
    got = ranks[0]["three"]
    assert [h["step"] for h in got] == [1, 2, 3]
    for g, w in zip(got, want):
        for k in ("loss", "ce", "acc", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=5e-4, err_msg=k)
    for r in ranks[1:]:
        assert [h["loss"] for h in r["three"]] == [h["loss"] for h in got]
        assert all(torch.equal(v, ranks[0]["state"][k])
                   for k, v in r["state"].items())
    # The resume continues bit for bit.
    resumed, five = ranks[0]["resumed"], ranks[0]["five"]
    assert [h["step"] for h in resumed] == [4, 5]
    for k in ("loss", "grad_norm", "acc"):
        assert [h[k] for h in resumed] == [h[k] for h in five[3:]], k
    # Rank 0 wrote every checkpoint, rank 1 none.
    assert ranks[0]["writes"] == [1, 2, 3, 4, 5, 1, 2, 3, 4, 5]
    assert ranks[1]["writes"] == []
    assert sorted(os.listdir(tmp_path / "a")) == [
        "1.pt", "2.pt", "3.pt", "4.pt", "5.pt", "metrics.jsonl"]
    with open(tmp_path / "a" / "metrics.jsonl") as f:
        lines = [json.loads(ln) for ln in f]
    assert lines == got + resumed


def _rank_multihost():
    """3 steps of the multi-host feed on the group that is up: the
    examples this rank read (in the order ``make_batches`` asked for
    them; the prefetch may read ahead), its history and its state."""
    torch.set_num_threads(1)
    seen = []
    getitem = ProcessShardDataset.__getitem__

    def counted(self, i):
        seen.append(i * self.pcount + self.pid)
        return getitem(self, i)
    ProcessShardDataset.__getitem__ = counted
    pipe, history = lt.train(_train_cfg(0, "", "train.multihost=true"),
                             device="cpu", progress=False)
    mesh = pipe.mesh
    return {"seen": seen, "history": history,
            "mesh": (mesh.world, mesh.rank, mesh.process_local),
            "state": pipe.model.state_dict()}


def test_multihost_feed_on_two_ranks():
    """``train.multihost`` on 2 ranks: each rank reads its strided shard
    (``ProcessShardDataset``) with seed ``train.seed + rank`` at a local
    batch of ``batch_size / 2``; the ranks' states stay equal, and the
    loss is one process's on the two local batches concatenated in rank
    order."""
    ranks = run_ranks(_rank_multihost, 2, device="cpu")
    cfg = _train_cfg(1, "")
    t = cfg.train
    local = t.batch_size // 2
    one = lt.build_model(cfg, device="cpu")
    one.init_state(t.seed)
    streams = []
    for r, rank in enumerate(ranks):
        assert rank["mesh"] == (2, r, True)
        order = []

        class Recorded:
            def __init__(self, data):
                self.data = data

            def __len__(self):
                return len(self.data)

            def __getitem__(self, i, order=order):
                order.append(i)
                return self.data[i]
        shard = ProcessShardDataset(Recorded(one.make_dataset("train")), r, 2)
        stream = make_batches(shard, cfg.budget, local, shuffle=True,
                              seed=t.seed + r,
                              augment_fn=one.augment_fn("train"))
        streams.append([next(stream) for _ in range(t.num_steps)])
        assert len(order) == t.num_steps * local
        assert rank["seen"][:len(order)] == order
        assert all(i % 2 == r for i in rank["seen"])
    assert set(ranks[0]["seen"]).isdisjoint(ranks[1]["seen"])
    for k, v in ranks[0]["state"].items():
        assert torch.equal(ranks[1]["state"][k], v), k
    for step, (a, b) in enumerate(zip(*streams)):
        aux = one.train_step({k: np.concatenate([a[k], b[k]]) for k in a})
        for rank in ranks:
            rec = rank["history"][step]
            assert rec["step"] == step + 1
            for k in ("loss", "ce", "acc", "grad_norm"):
                np.testing.assert_allclose(rec[k], float(aux[k]), rtol=5e-4,
                                           err_msg=k)


def test_concurrent_builds_write_their_own_temporary_files(tmp_path,
                                                           monkeypatch):
    """Ranks that launch a kernel first at the same time both compile: each
    nvcc writes a temporary file of its own, and one library is left."""
    import sys
    from concurrent.futures import ThreadPoolExecutor
    from lisec_tpu_torch.ops.cuda import build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    log = tmp_path / "nvcc.log"
    stub = tmp_path / "nvcc"
    stub.write_text(
        f"#!{sys.executable}\nimport sys, time\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        f"open({str(log)!r}, 'a').write(out + '\\n')\n"
        "time.sleep(0.5)\nopen(out, 'wb').write(b'library')\n")
    stub.chmod(0o755)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(stub))
    with ThreadPoolExecutor(2) as pool:
        results = list(pool.map(build.build, ["k", "k"]))
    assert all(r["seconds"] > 0 for r in results)
    tmps = log.read_text().split()
    assert len(tmps) == len(set(tmps)) == 2
    assert all(t.endswith(".tmp") for t in tmps)
    lib = build.library_path("k")
    assert os.listdir(tmp_path / "_build") == [lib.name]
    assert lib.read_bytes() == b"library"
