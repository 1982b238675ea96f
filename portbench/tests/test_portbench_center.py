"""The CenterPoint cell's loop, reference and span readers on the CPU: a
small cell (``center_tiny``), the CenterPoint configuration of the
benchmark cut to a small grid and narrow widths, added to a copy of
``portbench/`` as files and entries only. The program passes ``correct``
on it; the control and the planted faults (NMS off, threshold ignored)
do not; a traced run reports every span metric the cell lists."""

from __future__ import annotations

import copy
import json
import math
import shutil
from pathlib import Path

import pytest

from portbench.harness import spec
from portbench.harness.runner import run_cell

from .conftest import ROOT

CENTER = "center_tiny"
SPAN_METRICS = ["wire_pack_ms", "wire_unpack_ms", "forward_stream_ms",
                "decode_stream_ms", "nms_stream_ms", "nms_rounds",
                "rulebook_stream_ms"]
CENTER_METRICS = ["voxelize_stream_ms", "sparse_encoder_stream_ms",
                  "center_head_stream_ms"]


def tiny_center_config() -> dict:
    """The CenterPoint configuration of the benchmark on a 25.6 m square
    of 0.2 m voxels (BEV 16 x 16), narrow widths and small budgets."""
    with open(ROOT / "portbench" / "configs" / "centerpoint_nuscenes.json") as f:
        cfg = copy.deepcopy(json.load(f)["program_config"])
    cfg["model"]["params"].update(
        encoder_channels=[8, 8, 16, 16], encoder_out_channels=16,
        level_budgets=[4096, 4096, 2048, 1024, 512], bev_layers=[1, 1],
        bev_filters=[16, 32], bev_up_filters=[16, 16], head_channels=8,
        max_obj_per_sample=48, nms_post=24,
        post_center_range=[-15.0, -15.0, -10.0, 15.0, 15.0, 10.0])
    cfg["voxel"] = {"point_cloud_range": [-12.8, -12.8, -5.0, 12.8, 12.8, 3.0],
                    "voxel_size": [0.2, 0.2, 0.2]}
    cfg["budget"].update(max_points=16384, max_voxels=4096, nms_pre=288,
                         nms_post=144, nms_near=16)
    return cfg


def add_center_cell(root: Path) -> None:
    """Add the ``center_tiny`` cell by files and entries alone."""
    with open(root / "portbench/configs/centerpoint_nuscenes.json") as f:
        conf = json.load(f)
    conf.update(name="center_tiny", program_config=tiny_center_config())
    conf["weights"].update(weight_seed=3, calibrate_clouds=2,
                           positive_share=0.004)
    # On the CPU over seven seeds: bf16 det_gap_mean 0.073-0.205,
    # missed_mean 0.004-0.023, extra_share 0.003-0.026; fp8 0.56-1.56,
    # 0.038-0.28, 0.035-0.31; NMS off extra_share 0.038-0.19; threshold
    # ignored 0.105-0.73.
    conf["limits"] = {"det_gap_mean": 0.34, "missed_mean": 0.03,
                      "extra_share": 0.032}
    with open(root / "portbench/configs/center_tiny.json", "w") as f:
        json.dump(conf, f)
    with open(root / "portbench/traffic/serve_closed_b4_nusc10.json") as f:
        mix = json.load(f)
    mix.update(batch=2, pool=4, distinct_batches=2, warmup_requests=1,
               trace_skip=1, trace_requests=2, probe_calls=1,
               check_requests=2, reference_block=2)
    with open(root / "portbench/traffic/center_tiny_b2.json", "w") as f:
        json.dump(mix, f)
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"].append({"name": "center_tiny", "source": "test",
                             "file": "portbench/configs/center_tiny.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": CENTER, "config": "center_tiny",
                               "traffic": "center_tiny_b2", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "centerpoint_serve_b4" in m["workloads"]:
            m["workloads"].append(CENTER)
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)


@pytest.fixture(scope="module")
def center_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("bench_center")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    add_center_cell(root)
    return root


def _nms_off(loop):
    loop.pipeline.nms_iou = 1.01


def _threshold_ignored(loop):
    loop.pipeline.score_thr = -1.0


@pytest.mark.parametrize("fault", [_nms_off, _threshold_ignored])
def test_faults_come_out_not_correct(center_root, fault):
    r = run_cell(CENTER, 2**31 + 12, 1.0, False, device="cpu",
                 root=center_root, loop_hook=fault)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_control_fails_and_program_passes(center_root):
    """The program passes; the control and both planted faults fail."""
    cell = spec.load_cell(CENTER, center_root)
    d = cell.loop(cell, 2**31 + 15, "cpu")
    d.setup()
    d.window(0.5, False)
    d.release()
    limits = cell.config["limits"]
    program = d.check()
    assert all(program[k] <= v for k, v in limits.items()), program
    for stand_in in ("control", "nms_off", "threshold_ignored"):
        got = d.check(stand_in)
        assert any(got[k] > v for k, v in limits.items()), (stand_in, got)


def test_center_span_metrics_are_listed():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    sources = {m["name"]: m["source"] for m in bench["per_layer"]}
    assert all(sources[n] == "program_span" for n in CENTER_METRICS)


def test_traced_center_run_reports_every_span_metric(center_root):
    """The CenterPoint cell reports the shared span metrics and its own
    three, each finite and above 0."""
    from lisec_tpu_torch.utils.profiling import clear_spans
    clear_spans()
    r = run_cell(CENTER, 2**31 + 6, 0.5, True, device="cpu",
                 root=center_root)
    listed = [m["name"] for m in spec.load_cell(CENTER, center_root).per_layer
              if m["name"] in SPAN_METRICS + CENTER_METRICS]
    assert listed == SPAN_METRICS + CENTER_METRICS
    for name in listed:
        value = r["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0.0, name
    assert "spread_accumulate_roofline" not in r["metrics"]   # no card
    clear_spans()


@pytest.mark.parametrize("name", CENTER_METRICS)
def test_without_spans_in_the_program_a_reader_finds_nothing(
        name, monkeypatch):
    from lisec_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    assert spec.load_metric(name).read({}) is None
