"""``convergence_torch.py`` on the CPU at a tiny size: ``cli train`` then
``cli eval`` of a config, the records it writes, the ModelNet40 alias
pairs, a detector's recall split by difficulty, and the snapshot it
saves, which the JAX package's ``load_weights_npz`` reads."""

from __future__ import annotations

import json
import os
import sys

import jax
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import convergence_torch  # noqa: E402


def _run(tmp_path, name, config, *extra):
    out = tmp_path / "out"
    record = convergence_torch.main([
        name, os.path.join(ROOT, "configs", config), *extra,
        "--out", str(out), "--ckpt-dir", str(tmp_path / "ckpt"),
        "--device", "cpu"])
    with open(out / f"{name}_eval.json") as f:
        assert json.load(f) == json.loads(json.dumps(record))
    with open(out / f"{name}_metrics.jsonl") as f:
        curve = [json.loads(line) for line in f]
    return record, curve


def test_classifier_run_records_metrics_curve_and_alias_pairs(tmp_path):
    record, curve = _run(tmp_path, "cls", "pointnet_modelnet40_tiny.yaml",
                         "train.num_steps=4", "train.log_every=2",
                         "data.num_classes=40", "data.fixture_size=80")
    assert [r["step"] for r in curve] == [1, 2, 4]
    assert record["steps"] == 4 and record["overrides"][0].startswith("train")
    assert record["top1"] == record["accuracy"]
    assert record["top1"] <= record["alias_pair_accuracy"] <= 1.0
    assert record["alias_n"] == 80
    assert record["ms_per_step"] > 0 and record["nvidia_smi"] is None


def test_detector_run_splits_recall_and_saves_a_jax_readable_snapshot(
        tmp_path):
    from lisec_tpu.config import apply_overrides, load_config
    from lisec_tpu.api import build_model
    from lisec_tpu.bench_lib import load_weights_npz
    over = ["train.num_steps=2", "train.log_every=1",
            "data.fixture_size=8"]
    npz = str(tmp_path / "pp.npz")
    record, _ = _run(tmp_path, "pp", "pointpillars_tiny.yaml", *over,
                     "--recall-by-difficulty", "--save-weights", npz,
                     "--reference-weights", npz)
    split = record["recall_by_difficulty"]
    assert split == record["reference_recall_by_difficulty"]
    assert sum(v["gts"] for v in split.values()) > 0
    assert record["weights_bytes"] == os.path.getsize(npz)
    cfg = apply_overrides(load_config(os.path.join(
        ROOT, "configs", "pointpillars_tiny.yaml")), over)
    state = load_weights_npz(build_model(cfg).init_state(0), npz)
    saved = np.load(npz)
    for prefix, tree in (("params", state.params),
                         ("batch_stats", state.batch_stats)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = prefix + "/" + "/".join(p.key for p in path)
            np.testing.assert_array_equal(np.asarray(leaf), saved[key])


def test_a_run_from_its_own_initial_weights_equals_the_seeded_run(
        tmp_path, monkeypatch):
    from lisec_tpu_torch.pipelines.base import Pipeline
    import lisec_tpu_torch as lt
    from lisec_tpu_torch.bench_lib import save_weights_npz
    monkeypatch.setattr(Pipeline, "init_state", Pipeline.init_state)
    over = ["train.num_steps=3", "train.log_every=1", "data.fixture_size=8"]
    path = os.path.join(ROOT, "configs", "pointpillars_tiny.yaml")
    pipe = lt.build_model(lt.apply_overrides(lt.load_config(path), over),
                          device="cpu")
    pipe.init_state(0)
    npz = str(tmp_path / "init.npz")
    save_weights_npz(pipe.model, npz)
    _, seeded = _run(tmp_path / "a", "a", "pointpillars_tiny.yaml", *over)
    record, loaded = _run(tmp_path / "b", "b", "pointpillars_tiny.yaml",
                          *over, "--init-weights", npz)
    assert record["init_weights"] == npz
    drop = ("clouds_per_sec",)
    assert [{k: v for k, v in r.items() if k not in drop} for r in loaded] \
        == [{k: v for k, v in r.items() if k not in drop} for r in seeded]
