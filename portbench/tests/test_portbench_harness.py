"""The harness on the CPU: cells found by name, the result line, the
import guard, and ``correct`` under a sound program, the control and
planted faults (the ``tiny`` cell, added as files only)."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import guard, spec
from portbench.harness.runner import run_cell

from .conftest import MARKED, ROOT, TINY, TRAINED

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_benchmark_names_resolve_to_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.loop.__module__.endswith(cell.traffic["mode"])
        assert callable(cell.reference.forward)
        assert callable(cell.counters.count)
        spec.load_module("traffic", cell.traffic["scenes"])
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
    for m in bench["per_layer"]:
        mod = spec.load_metric(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
            m["layer"], m["unit"], m["moves"], m["source"]), m["name"]
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()


def test_cell_added_as_files_only_is_picked_up(tiny_root):
    cell = spec.load_cell(TINY, tiny_root)
    assert cell.config_name == "pp_tiny" and cell.traffic["batch"] == 4
    assert "pillar_canvas_roofline" in {m["name"] for m in cell.per_layer}
    with pytest.raises(KeyError):
        spec.load_cell(TINY)


def test_new_mode_and_model_added_as_files_only_run(tiny_root, capsys):
    """A cell whose loop mode, reference model and work counter are all
    new files runs through them, with nothing else edited."""
    r = run_cell(MARKED, 2**31 + 21, 0.5, True, device="cpu",
                 root=tiny_root)
    assert r["correct"] is True and r["metrics"]
    assert "mode serve_marked; requests:" in capsys.readouterr().err
    assert spec.load_module("reference", "pp_marked", tiny_root).CALLS
    assert spec.load_module("counters", "pp_marked", tiny_root).CALLS


def test_pointpillars_flops_from_published_widths():
    with open(ROOT / "portbench/configs/pointpillars_kitti.json") as f:
        cfg = json.load(f)["program_config"]
    flops = spec.load_module("counters", "pointpillars").pointpillars_flops
    assert abs(flops(cfg) - 73.2e9) < 0.05e9


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(tiny_root, traced, capsys):
    r = run_cell(TINY, 2**31 + 11, 1.0, traced, device="cpu",
                 root=tiny_root)
    want = KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(r) == want
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    if traced:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == {"clouds_per_s", "latency_p95_ms",
                                     "setup_s"}
    err = capsys.readouterr().err.strip().splitlines()
    n = len(r["checks"])
    assert err[-n - 1].startswith("correct: True")
    assert [l.split(":")[0] for l in err[-n:]] == [
        f"check {k}" for k in r["checks"]]
    json.dumps(r)


def _half_left_out(loop):
    predict = loop.pipeline.predict

    def broken(batch):
        out = predict(batch)
        half = out["valid"].shape[0] // 2
        out["valid"] = out["valid"].clone()
        out["valid"][half:] = False
        return out
    loop.pipeline.predict = broken


def _answer_altered(loop):
    predict = loop.pipeline.predict

    def broken(batch):
        out = predict(batch)
        out["boxes"] = out["boxes"].clone()
        out["boxes"][:, 0, 0] += 1.0
        return out
    loop.pipeline.predict = broken


def _nms_off(loop):
    loop.pipeline.nms_iou = 1.01


def _threshold_ignored(loop):
    loop.pipeline.score_thr = -1.0


@pytest.mark.parametrize("cell,fault", [
    (TINY, _half_left_out), (TINY, _answer_altered),
    (TRAINED, _nms_off), (TRAINED, _threshold_ignored)])
def test_faults_come_out_not_correct(tiny_root, cell, fault):
    r = run_cell(cell, 2**31 + 12, 1.0, False, device="cpu",
                 root=tiny_root, loop_hook=fault)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("name,seed", [(TINY, 3), (TINY, 2**31 + 13),
                                       (TRAINED, 2**31 + 14)])
def test_control_fails_and_program_passes(tiny_root, name, seed):
    """The program passes; the control fails, on the tiny cell as on the
    trained one; the planted faults fail where NMS has work (the trained
    cell)."""
    cell = spec.load_cell(name, tiny_root)
    d = cell.loop(cell, seed, "cpu")
    d.setup()
    d.window(0.5, False)
    d.release()
    limits = cell.config["limits"]
    program = d.check()
    assert all(program[k] <= v for k, v in limits.items()), program
    for stand_in in ("control", "nms_off", "threshold_ignored")[
            :3 if name == TRAINED else 1]:
        got = d.check(stand_in)
        assert any(got[k] > v for k, v in limits.items()), (stand_in, got)


@pytest.mark.parametrize("model", ["pointpillars", "second"])
def test_reference_matches_the_port_in_float32(model):
    """The reference's per-anchor outputs against the port's model on the
    same dequantized points, both in float32, with seed weights (SECOND's
    BatchNorms calibrated as its cell's are)."""
    from lisec_tpu_torch.api import build_model
    from lisec_tpu_torch.config import config_from_dict
    from lisec_tpu_torch.data.wire import pack_points_q16, unpack_points_q16
    from lisec_tpu_torch.weights import convert_flax_arrays, to_flax_arrays
    from portbench.harness import weights as wmod
    from portbench.harness.pool import make_pool
    from portbench.reference import wire

    from .conftest import tiny_program_config, tiny_second_config
    cfg = (tiny_program_config() if model == "pointpillars"
           else tiny_second_config())
    cfg["model"]["params"]["dtype"] = "float32"
    pipe = build_model(config_from_dict(cfg), device="cpu")
    layout = {k: tuple(v.shape)
              for k, v in to_flax_arrays(pipe.model).items()}
    draw = {"gain": 2.0, "head_gains": [8.0, 0.02, 1.0], "class_bias": -2.5,
            "calibrate_clouds": 1, "positive_share": 0.01}
    ref = spec.load_module("reference", model)
    pts, counts = make_pool(cfg, "raycast_hard", 3, 5, ROOT)
    w = wmod.seed_draw(layout, draw, 5, "cpu")
    if model == "second":
        wmod.calibrate(w, draw, torch.as_tensor(pts),
                       torch.as_tensor(counts), cfg, ref)
    pipe.model.load_state_dict(convert_flax_arrays(
        {k: v.numpy() for k, v in w.items()}))
    pipe.model.eval()
    mask = np.arange(pts.shape[1])[None] < counts[:, None]
    staged = unpack_points_q16({k: torch.as_tensor(v) for k, v in
                                pack_points_q16(pts, mask).items()})
    q, lo, scale = wire.pack_q16(pts, counts)
    ref_pts = wire.dequantize(q, lo, scale, "cpu")
    assert torch.equal(ref_pts[staged["point_mask"]],
                       staged["points"][staged["point_mask"]])
    with torch.no_grad():
        got = pipe.model(*pipe._model_args(staged))
        want = ref.forward(ref_pts, torch.as_tensor(counts), w, cfg)
    for k in ("cls", "box", "dir"):
        scale_k = want[k].abs().max()
        assert (got[k] - want[k]).abs().max() <= 1e-4 * scale_k, k


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in guard.FORBIDDEN, (path, name)
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] != "lisec_tpu_torch", (path, name)


def test_dry_run_loads_no_jax(tiny_root):
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from portbench.harness.runner import run_cell\n"
            "from pathlib import Path\n"
            "r = run_cell('tiny', 7, 0.5, False, device='cpu', "
            "root=Path(%r))\n"
            "print(json.dumps(sorted(k for k in sys.modules "
            "if k.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'lisec_tpu'))))" % (str(ROOT), str(tiny_root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []


def test_a_loaded_jax_module_withholds_the_result(tiny_root, monkeypatch,
                                                  capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run_cell(TINY, 8, 0.5, False, device="cpu",
                    root=tiny_root) is None
    assert "jax" in capsys.readouterr().err


def test_without_a_card_the_command_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench/run.py"), "--workload",
         "pp_serve_b32", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.card
def test_cell_and_control_on_the_card(card, tmp_path):
    """Every cell for a short window on the card, and the control and the
    planted faults at the cell's size on three seeds: the program
    correct, the control and each fault not."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        proc = subprocess.run(
            [sys.executable, str(ROOT / "portbench/run.py"), "--workload",
             w["name"], "--seed", "2147483701", "--seconds", "3",
             "--trace", "0"], capture_output=True, text=True, check=True)
        assert json.loads(proc.stdout.splitlines()[-1])["correct"]
        out = tmp_path / f"{w['name']}.jsonl"
        subprocess.run(
            [sys.executable, str(ROOT / "portbench/calibrate.py"),
             "--workload", w["name"], "--seeds", "41,42,43",
             "--seconds", "2", "--out", str(out)], check=True)
        limits = spec.load_cell(w["name"]).config["limits"]
        for line in out.read_text().splitlines():
            rec = json.loads(line)
            assert all(rec["program"][k] <= v for k, v in limits.items())
            for stand_in in ("control", "nms_off", "threshold_ignored"):
                assert any(rec[stand_in][k] > v
                           for k, v in limits.items()), stand_in
