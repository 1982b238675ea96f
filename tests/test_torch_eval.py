"""The port's evaluation (metrics, detection matching, KITTI AP, each
pipeline's ``evaluate``, the eval hook, ``run_evaluation`` and
``api.evaluate``) against the JAX package's, on the CPU.

The metric functions take random inputs made with numpy from seeds; each
pipeline's ``evaluate`` runs on its tiny config with JAX
``init_state(0)``'s weights carried across by ``weights.py``. The trained
PointPillars snapshot's encoder canvas and predict on held-out frames are
held against the JAX package's at full width; run as a module, the file
prints the JAX package's evaluations of that snapshot (see the end).
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisec_tpu
import lisec_tpu_torch
from lisec_tpu.bench_lib import load_weights_npz as jax_load_weights_npz
from lisec_tpu.bench_lib import save_weights_npz
from lisec_tpu.config import apply_overrides as jax_apply_overrides
from lisec_tpu.config import load_config as jax_load_config
from lisec_tpu.data.collate import make_batches as jax_make_batches
from lisec_tpu.eval import detection as jax_det
from lisec_tpu.eval import kitti_ap as jax_ap
from lisec_tpu.training import metrics as jax_metrics
from lisec_tpu_torch.config import apply_overrides
from lisec_tpu_torch.eval import detection, kitti_ap
from lisec_tpu_torch.training import metrics
from lisec_tpu_torch.training.loop import run_evaluation, run_training
from lisec_tpu_torch.weights import load_weights_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name):
    return os.path.join(ROOT, "configs", f"{name}.yaml")


# -- metrics ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_equal_the_jax_copies(seed):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, 6, 300)
    label = np.where(rng.random(300) < 0.5, pred, rng.integers(-1, 6, 300))
    results = []
    for mod in (metrics, jax_metrics):
        acc = mod.AccuracyMeter(7)        # class 6 never seen
        iou = mod.IoUMeter(6, ignore=-1)
        for a, b in ((0, 120), (120, 300)):
            keep = label[a:b] >= 0
            acc.update(pred[a:b][keep], label[a:b][keep])
            iou.update(pred[a:b], label[a:b])
        results.append((acc.overall(), acc.class_mean(), iou.miou(),
                        iou.miou(True), iou.per_class().tolist()))
    assert results[0] == results[1]
    assert metrics.AccuracyMeter(3).class_mean() == 0.0
    preds = [rng.integers(0, 9, 50) for _ in range(4)]
    labels = [rng.integers(0, 9, 50) for _ in range(4)]
    parts = [range(3 * (i % 3), 3 * (i % 3) + 3) for i in range(4)]
    assert metrics.instance_miou(preds, labels, parts) == \
        jax_metrics.instance_miou(preds, labels, parts)


# -- detection matching and KITTI AP ------------------------------------------

def _boxes(rng, n, spread=6.0):
    """Car-sized boxes (x, y, z, l, w, h, yaw) in a small area, so that
    many pairs overlap."""
    return np.concatenate([
        rng.uniform(0, spread, (n, 2)), rng.normal(-1.0, 0.2, (n, 1)),
        rng.normal([3.9, 1.6, 1.55], 0.3, (n, 3)),
        rng.uniform(-np.pi, np.pi, (n, 1))], axis=1).astype(np.float32)


def _frames(seed, n_frames=6, num_classes=2):
    """Random detections (noisy copies of the gts and false ones) and gts
    with difficulty buckets and ignored gts."""
    rng = np.random.default_rng(seed)
    dets, gts = [], []
    for _ in range(n_frames):
        g = int(rng.integers(0, 6))
        gt = _boxes(rng, g)
        noisy = gt + rng.normal(0, 0.15, gt.shape).astype(np.float32)
        boxes = np.concatenate([noisy, _boxes(rng, int(rng.integers(0, 5)))])
        dets.append({
            "boxes": boxes,
            "scores": rng.random(len(boxes)).astype(np.float32),
            "labels": rng.integers(0, num_classes, len(boxes)).astype(
                np.int32)})
        gts.append({
            "boxes": gt,
            "classes": rng.integers(0, num_classes, g).astype(np.int32),
            "difficulty": rng.integers(-1, 3, g).astype(np.int32)})
    return dets, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matching_and_iou_equal_the_jax_copies(seed):
    dets, gts = _frames(seed)
    for det, gt in zip(dets, gts):
        for metric in ("3d", "bev"):
            got = detection.iou_matrix_np(det["boxes"], gt["boxes"], metric)
            want = jax_det.iou_matrix_np(det["boxes"], gt["boxes"], metric)
            np.testing.assert_array_equal(got, want)
        kw = dict(iou_threshold=0.5)
        args = (det["boxes"], det["labels"], gt["boxes"], gt["classes"])
        assert detection.match_frame(*args, **kw) == \
            jax_det.match_frame(*args, **kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_kitti_ap_equals_the_jax_copy(seed):
    dets, gts = _frames(seed, n_frames=12)
    for metric in ("3d", "bev"):
        for fn in ("evaluate_kitti_ap", "evaluate_kitti_ap_official"):
            for points in (11, 40):
                kw = dict(class_ids=(0, 1), metric=metric, num_points=points)
                got = getattr(kitti_ap, fn)(dets, gts, **kw)
                want = getattr(jax_ap, fn)(dets, gts, **kw)
                assert got.keys() == want.keys()
                for k in want:
                    np.testing.assert_allclose(got[k], want[k], rtol=0,
                                               atol=1e-6, err_msg=k)
    assert any(v > 0 for v in kitti_ap.kitti_ap(dets, gts, 2).values())


# -- each pipeline's evaluate -------------------------------------------------

TINY_CONFIGS = ["pointnet_modelnet40_tiny", "pointnet2_partseg_tiny",
                "rangeseg_tiny", "pointpillars_tiny", "second_tiny"]


@pytest.mark.parametrize("name", TINY_CONFIGS)
def test_evaluate_equals_jax(name, tmp_path):
    """``evaluate(max_batches=1)`` from JAX ``init_state(0)``'s weights:
    counts exactly, floats within 1e-6."""
    jax_pipe = lisec_tpu.build_model(jax_load_config(_config(name)))
    dummy = jax.tree.map(jnp.asarray, jax_pipe.dummy_batch())
    v = jax.jit(jax_pipe.init_variables)(jax.random.PRNGKey(0), dummy)
    state = types.SimpleNamespace(params=v["params"],
                                  batch_stats=v.get("batch_stats", {}))
    want = jax_pipe.evaluate(state, max_batches=1)
    path = str(tmp_path / "w.npz")
    save_weights_npz(state, path)
    port = lisec_tpu_torch.build_model(
        lisec_tpu_torch.load_config(_config(name)), device="cpu")
    load_weights_npz(port.model, path)
    port.model.train()
    got = port.evaluate(max_batches=1)
    assert not port.model.training                     # left in eval()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    if name.startswith(("pointpillars", "second")):
        assert any("official" in k for k in got)


def test_detection_evaluate_without_ap_and_over_frames():
    """``eval_ap: false`` gives recall and the detection count only; with
    AP, ``collect_detections`` reads the frames the recall counts, and
    ``evaluate_pipeline_ap`` gives the same AP."""
    cfg = lisec_tpu_torch.load_config(_config("pointpillars_tiny"))
    pipe = lisec_tpu_torch.build_model(cfg, device="cpu")
    full = pipe.evaluate(max_batches=2)
    dets, gts = kitti_ap.collect_detections(pipe, max_frames=5)
    assert len(dets) == len(gts) == 8                  # two whole batches
    assert full["mean_detections"] == sum(len(d["boxes"]) for d in dets) / 8
    assert sum(len(g["boxes"]) for g in gts) > 0
    assert kitti_ap.evaluate_pipeline_ap(pipe, max_frames=5) == {
        k: v for k, v in full.items() if "_ap_" in k}
    no_ap = lisec_tpu_torch.build_model(
        apply_overrides(cfg, ["model.params.eval_ap=false"]), device="cpu")
    assert no_ap.evaluate(max_batches=2) == {
        k: full[k] for k in ("recall@0.5", "mean_detections")}


# -- the eval hook and the entry points ---------------------------------------

def test_eval_hook_logs_step_and_metrics(tmp_path):
    """The hook at ``train.eval_every`` adds ``{"step", "eval"}`` to the
    history and the JSONL, as the JAX loop does; training goes on in
    ``train()`` mode after it."""
    cfg = apply_overrides(
        lisec_tpu_torch.load_config(_config("pointnet_modelnet40_tiny")),
        ["train.num_steps=4", "train.log_every=2", "train.eval_every=2",
         "data.fixture_size=16"])
    path = str(tmp_path / "run" / "metrics.jsonl")
    pipe, history = run_training(cfg, device="cpu", progress=False,
                                 metrics_path=path)
    evals = [h for h in history if "eval" in h]
    assert [h["step"] for h in evals] == [2, 4]
    assert all(set(h) == {"step", "eval"} for h in evals)
    assert set(evals[0]["eval"]) == {"accuracy", "class_mean_accuracy"}
    assert [h["step"] for h in history] == [1, 2, 2, 4, 4]
    with open(path) as f:
        assert [json.loads(line) for line in f] == history
    assert evals[-1]["eval"] == pipe.evaluate()
    assert pipe.step == 4


def test_run_evaluation_and_api_evaluate(capsys, tmp_path):
    cfg = lisec_tpu_torch.load_config(_config("pointnet_modelnet40_tiny"))
    # With a checkpoint directory, the latest checkpoint's weights.
    ckpt = apply_overrides(cfg, [f"train.ckpt_dir={tmp_path / 'run'}",
                                 "train.num_steps=3", "train.log_every=10"])
    trained, _ = lisec_tpu_torch.train(ckpt, device="cpu", progress=False)
    restored = run_evaluation(ckpt, device="cpu")
    assert restored == trained.evaluate()
    capsys.readouterr()
    fresh = lisec_tpu_torch.evaluate(cfg, device="cpu")
    assert fresh != restored
    assert set(fresh) == {"accuracy", "class_mean_accuracy"}
    assert json.loads(capsys.readouterr().out) == fresh
    pipe = lisec_tpu_torch.build_model(cfg, device="cpu")
    pipe.init_state(cfg.train.seed)
    assert lisec_tpu_torch.evaluate(cfg, pipe) == fresh


# -- the record the snapshot evaluation is held against -----------------------

def _routing_shift(w, t, pc_range):
    """The JAX encoder kernel's BIG: per channel a bound of |u|, of the
    cell-centre term and of |t| over the range, plus 1."""
    from lisec_tpu_torch.ops.cuda import encoder_kernel as ek
    we = ek._weff(w)
    bound = torch.tensor([max(abs(lo), abs(hi)) for lo, hi in
                          zip(pc_range[:3], pc_range[3:])] + [1.0])
    return (we.abs().T @ bound + w[7].abs() * bound[0]
            + w[8].abs() * bound[1] + t.abs() + 1.0)


def _bf16_routed_canvas(points, point_mask, w, t, *, grid, voxel_size,
                        pc_range):
    """The JAX encoder kernel's arithmetic with a bf16 canvas, in plain
    torch: each cell's max of u + BIG (BIG a per-channel bound of |u|,
    of the centre term and of |t| over the range) routed as one bf16
    value, the epilogue adding t - BIG (see :func:`_routing_shift`). The
    port's encoder does not route: its cell max is exact."""
    from lisec_tpu_torch.ops.cuda import encoder_kernel as ek
    nx, ny = grid
    ncells, b, c = nx * ny, points.shape[0], w.shape[1]
    cell_s, pts_s, _ = ek.sort_by_cell(points, point_mask, grid=grid,
                                       voxel_size=voxel_size,
                                       pc_range=pc_range)
    x, y, z, r = (pts_s[..., i:i + 1] for i in range(4))
    we = ek._weff(w)
    big = _routing_shift(w, t, pc_range)
    u = (((x * we[0] + y * we[1]) + z * we[2]) + r * we[3]) + big
    rows = (cell_s.long() + torch.arange(b)[:, None]
            * (ncells + 1)).reshape(-1)
    umax = torch.full((b * (ncells + 1), c), float("-inf")).scatter_reduce_(
        0, rows[:, None].expand(-1, c), u.reshape(-1, c), "amax",
        include_self=False)
    stats = torch.cat([pts_s[..., :3], torch.ones_like(x)], -1)
    sums = torch.zeros((b * (ncells + 1), 4), dtype=torch.float64
                       ).index_add_(0, rows, stats.reshape(-1, 4).double())
    umax = umax.view(b, ncells + 1, c)[:, :ncells].to(torch.bfloat16).float()
    sums = sums.view(b, ncells + 1, 4)[:, :ncells].float()
    count = sums[..., 3:4]
    mean = sums[..., :3] / count.clamp_min(1.0)
    b_mean = ((mean[..., 0:1] * w[4] + mean[..., 1:2] * w[5])
              + mean[..., 2:3] * w[6])
    cx, cy = ek.cell_centers(ncells, nx, voxel_size, pc_range, "cpu")
    b_ctr = cx[:, None] * w[7] + cy[:, None] * w[8]
    v = ((umax - b_mean) - b_ctr) + (t - big)
    return torch.where(count > 0, v.clamp_min(0.0), 0.0).to(torch.bfloat16)


def test_plain_encoder_reproduces_the_jax_bf16_routed_canvas():
    """The JAX package's encoder kernel with a bf16 canvas (its production
    setting, which made ``docs/convergence/pphard_eval.json``) routes each
    cell's max of u + BIG as one bf16 value. With the trained snapshot's
    weights on a held-out frame, the port's exact canvas differs from it
    by up to a few units; that routing written out in torch equals it but
    for a last-bit rounding of the f32 epilogue on few entries. With an
    f32 canvas the JAX kernel routes u as two bf16 terms and agrees with
    the port's canvas."""
    from lisec_tpu.ops.pallas.encoder_kernel import (
        pillar_canvas_fused as jax_canvas)
    from lisec_tpu_torch.data.fixtures import make_detection_scene_hard
    from lisec_tpu_torch.ops.cuda import encoder_kernel as ek
    snap = np.load(os.path.join(ROOT, "weights",
                                "pointpillars_fixture_hard.npz"))
    enc = {k.rsplit("/", 1)[1]: snap[k] for k in snap.files
           if "FusedPillarEncoder_0" in k}
    s = enc["scale"] / np.sqrt(enc["var"] + 1e-3)         # BN eps 1e-3
    w = (enc["kernel"] * s[None]).astype(np.float32)
    t = (enc["bias"] - s * enc["mean"]).astype(np.float32)
    geo = dict(grid=(432, 496), voxel_size=(0.16, 0.16),
               pc_range=(0.0, -39.68, -3.0, 69.12, 39.68, 1.0))
    pts = make_detection_scene_hard(
        30_000, pc_range=geo["pc_range"])["points"][None, :6000]
    mask = np.ones(pts.shape[:2], bool)
    want, want32 = (np.asarray(jax_canvas(
        *(jnp.asarray(a) for a in (pts, mask, w, t)),
        out_dtype=d, interpret=True, **geo)).astype(np.float32)
        for d in (jnp.bfloat16, jnp.float32))
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (pts, mask, w, t)]
    routed = _bf16_routed_canvas(*args, **geo).float().numpy()
    exact, exact32 = (ek.pillar_canvas_fused_reference(
        *args, out_dtype=d, **geo).float().numpy()
        for d in (torch.bfloat16, torch.float32))
    occupied = np.abs(want).sum(-1) > 0
    assert occupied.sum() > 3000
    # One bf16 step of the largest value at most, on under 1% of entries.
    assert (routed == want)[occupied].mean() > 0.99
    assert np.abs(routed - want).max() <= 2.0 ** -7 * np.abs(want).max()
    assert np.abs(exact - want).max() > 1.0
    assert (exact == want)[occupied].mean() < 0.7
    # Two bf16 terms of u + BIG: an error of about BIG * 2^-17 at most.
    big = float(_routing_shift(args[2], args[3], geo["pc_range"]).max())
    assert np.abs(exact32 - want32).max() <= 2.0 ** -16 * big


# -- the trained PointPillars snapshot on held-out frames ---------------------

SNAPSHOT = os.path.join(ROOT, "weights", "pointpillars_fixture_hard.npz")
SNAPSHOT_CONFIG = _config("pointpillars_fixture_hard_conv")


def _snapshot_pipelines(overrides):
    """The JAX package's pipeline and state and the port's CPU pipeline of
    ``pointpillars_fixture_hard_conv.yaml`` with ``overrides``, both
    holding the trained snapshot. ``model.params.fast_encoder=false``
    puts the JAX model on its reference encoder path (an exact cell max,
    as the port's encoder computes it) instead of its kernel."""
    overrides = ['train.ckpt_dir=""', *overrides]
    jax_pipe = lisec_tpu.build_model(
        jax_apply_overrides(jax_load_config(SNAPSHOT_CONFIG), overrides))
    state = jax_load_weights_npz(jax_pipe.init_state(0), SNAPSHOT)
    port = lisec_tpu_torch.build_model(apply_overrides(
        lisec_tpu_torch.load_config(SNAPSHOT_CONFIG), overrides),
        device="cpu")
    load_weights_npz(port.model, SNAPSHOT)
    return jax_pipe, state, port


def snapshot_frames(jax_pipe, state, port, max_batches):
    """The first ``max_batches`` held-out batches through the JAX
    package's predict and the port's. Per frame: the kept counts, the
    least best BEV IoU of a JAX box with a port box, and the largest
    score difference of those pairs."""
    cfg = jax_pipe.cfg
    jax_batches = jax_make_batches(jax_pipe.make_dataset("val"), cfg.budget,
                                   cfg.train.batch_size, shuffle=False,
                                   epochs=1)
    frames = []
    for (batch, got), jax_batch in zip(port.eval_outputs("val", max_batches),
                                       jax_batches):
        np.testing.assert_array_equal(batch["points"], jax_batch["points"])
        want = jax.device_get(jax_pipe.infer(state, jax_batch))
        for i in range(len(got["valid"])):
            wv, gv = np.asarray(want["valid"][i]), got["valid"][i]
            iou = detection.iou_matrix_np(
                np.asarray(want["boxes"][i])[wv].astype(np.float64),
                got["boxes"][i][gv].astype(np.float64), "bev")
            pairs = (iou.argmax(1) if iou.size else [])
            frames.append({
                "jax_kept": int(wv.sum()), "port_kept": int(gv.sum()),
                "least_best_iou": float(iou.max(1).min()) if iou.size
                else None,
                "largest_score_diff": float(np.abs(
                    got["scores"][i][gv][pairs]
                    - np.asarray(want["scores"][i])[wv]).max())
                if iou.size else None})
    return frames


def test_snapshot_predict_equals_jax_on_held_out_frames():
    """The trained snapshot on the first held-out frame, in f32, through
    the JAX package's reference encoder path and through the port on the
    CPU: the same kept boxes, scores within 1e-5."""
    frames = snapshot_frames(*_snapshot_pipelines([
        "model.params.dtype=float32", "model.params.fast_encoder=false",
        "train.batch_size=1"]), 1)
    assert len(frames) == 1
    for f in frames:
        assert f["jax_kept"] == f["port_kept"] > 0
        assert f["least_best_iou"] > 0.9999
        assert f["largest_score_diff"] < 1e-5


def _against_tpu_record(out):
    """The first held-out batch's outputs against the JAX package's
    predict of it on the TPU (``docs/convergence/
    pphard_trained_outputs.npz``): per frame the kept counts and, for
    each recorded box, the best BEV IoU of a box in ``out`` and that
    box's score less the recorded one."""
    ref = np.load(os.path.join(ROOT, "docs", "convergence",
                               "pphard_trained_outputs.npz"))
    frames = []
    for i in range(len(ref["valid"])):
        rv, ov = ref["valid"][i], np.asarray(out["valid"][i])
        iou = detection.iou_matrix_np(
            ref["boxes"][i][rv].astype(np.float64),
            np.asarray(out["boxes"][i])[ov].astype(np.float64), "bev")
        pairs = iou.argmax(1)
        frames.append({
            "tpu_kept": int(rv.sum()), "kept": int(ov.sum()),
            "best_iou": iou.max(1).round(4).tolist(),
            "score_minus_tpu": (np.asarray(out["scores"][i])[ov][pairs]
                                - ref["scores"][i][rv]).round(4).tolist()})
    return frames


def snapshot_record():
    """The JAX package's ``evaluate`` of the trained snapshot over the 256
    held-out frames on the CPU, with its production encoder kernel (a
    bf16 canvas: each cell's max routed as one bf16 value) and with its
    reference encoder path, each path's first held-out batch beside the
    JAX package's predict of it on the TPU; and the first two held-out
    batches through the reference path and the port on the CPU, in f32
    and in bf16."""
    record = {}
    for name, fast in (("production_encoder", "true"),
                       ("reference_encoder", "false")):
        jax_pipe, state, _ = _snapshot_pipelines(
            [f"model.params.fast_encoder={fast}"])
        first = next(jax_make_batches(
            jax_pipe.make_dataset("val"), jax_pipe.cfg.budget,
            jax_pipe.cfg.train.batch_size, shuffle=False, epochs=1))
        record[name] = {
            **{k: float(v) for k, v in jax_pipe.evaluate(state).items()},
            "first_batch_against_tpu": _against_tpu_record(
                jax.device_get(jax_pipe.infer(state, first)))}
    for dtype in ("float32", "bfloat16"):
        record[f"first_batches_{dtype}"] = snapshot_frames(
            *_snapshot_pipelines([f"model.params.dtype={dtype}",
                                  "model.params.fast_encoder=false"]), 2)
    return record


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python -m tests.test_torch_eval, from the
    # repository's root (about 25 minutes on 8 cores; JAX's default
    # settings, as its own ``evaluate`` runs): the JAX package's
    # evaluations of the snapshot that chip_smoke.py holds the port's to.
    print(json.dumps(snapshot_record(), indent=1))
