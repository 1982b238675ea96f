"""Tests of the benchmark harness. Run from the repository root:

    python -m pytest portbench/tests -q

Tests marked ``card`` need an NVIDIA card and skip without one; whether a
card is there is decided inside the ``card`` fixture, never at import.
The CPU tests drive a small cell (``tiny``) that they add to a copy of
``portbench/`` as files only: a configuration, a traffic mix and
``BENCHMARK.json`` entries; a second (``marked``) that runs it under a
loop mode, a reference model and a work counter that are new files too;
and a third (``trained``), the PointPillars configuration as the
benchmark runs it at batch 2.
"""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = "tiny"
MARKED = "marked"
TRAINED = "trained"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on an NVIDIA card")
    return "cuda"


def tiny_program_config() -> dict:
    """The PointPillars configuration of the benchmark, cut to a 64 x 64
    grid of 1 m pillars, 32 filters, and small NMS budgets."""
    with open(ROOT / "portbench" / "configs" / "pointpillars_kitti.json") as f:
        cfg = copy.deepcopy(json.load(f)["program_config"])
    cfg["model"]["params"].update(pfn_filters=32, score_threshold=0.05)
    cfg["voxel"] = {"point_cloud_range": [0.0, -32.0, -3.0, 64.0, 32.0, 1.0],
                    "voxel_size": [1.0, 1.0, 4.0]}
    cfg["budget"].update(max_points=24576, nms_pre=256, nms_post=32)
    return cfg


def tiny_second_config() -> dict:
    """The SECOND configuration of the benchmark, cut to a 64 x 64 x 16
    grid, narrow channels and small budgets."""
    with open(ROOT / "portbench" / "configs" / "second_kitti.json") as f:
        cfg = copy.deepcopy(json.load(f)["program_config"])
    cfg["model"]["params"].update(
        encoder_channels=[8, 16, 32, 32], level_budgets=[1024, 768, 384, 192],
        dense_from_level=2, bev_layers=[2, 2], bev_filters=[32, 64],
        bev_up_filters=[64, 64], score_threshold=0.05)
    cfg["voxel"] = {"point_cloud_range": [0.0, -16.0, -3.0, 32.0, 16.0, 1.0],
                    "voxel_size": [0.5, 0.5, 0.25]}
    cfg["budget"].update(max_points=8192, max_voxels=1024, nms_pre=256,
                         nms_post=32)
    return cfg


def add_tiny_cell(root: Path) -> None:
    """Add the ``tiny`` cell to the benchmark under ``root`` by files and
    entries alone."""
    conf = {"name": "pp_tiny", "reference": "pointpillars",
            "counters": "pointpillars",
            "weights": {"kind": "seed", "weight_seed": 3, "gain": 2.0,
                        "head_gains": [0.02, 0.02, 0.02], "class_bias": -2.5},
            "limits": {"det_gap_mean": 0.05, "missed": 0.05,
                       "extra_share": 0.05},
            "program_config": tiny_program_config()}
    with open(root / "portbench/configs/pp_tiny.json", "w") as f:
        json.dump(conf, f)
    with open(root / "portbench/traffic/serve_closed_b32.json") as f:
        mix = json.load(f)
    mix.update(batch=4, pool=8, distinct_batches=2, warmup_requests=1,
               trace_skip=1, trace_requests=2, probe_calls=2,
               check_requests=2, reference_block=4)
    with open(root / "portbench/traffic/tiny_b4.json", "w") as f:
        json.dump(mix, f)
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"].append({"name": "pp_tiny", "source": "test",
                             "file": "portbench/configs/pp_tiny.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": TINY, "config": "pp_tiny",
                               "traffic": "tiny_b4", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "pp_serve_b32" in m["workloads"]:
            m["workloads"].append(TINY)
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)


def add_trained_cell(root: Path) -> None:
    """Add the ``trained`` cell: ``pointpillars_kitti`` as the benchmark
    runs it, trained snapshot and all, at batch 2. Its scores cluster
    around objects as a trained detector's do, so NMS has boxes to
    suppress, which a seed draw's scattered scores do not give it."""
    with open(root / "portbench/traffic/serve_closed_b32.json") as f:
        mix = json.load(f)
    mix.update(batch=2, pool=2, distinct_batches=1, warmup_requests=1,
               trace_skip=1, trace_requests=1, probe_calls=1,
               check_requests=1, reference_block=2)
    with open(root / "portbench/traffic/trained_b2.json", "w") as f:
        json.dump(mix, f)
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["workloads"].append({"name": TRAINED,
                               "config": "pointpillars_kitti",
                               "traffic": "trained_b2", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "pp_serve_b32" in m["workloads"]:
            m["workloads"].append(TRAINED)
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)


# A loop mode, a reference model and its work counter that the benchmark
# has never seen, each a new file; each leaves a mark where it ran.
NEW_FILES = {
    "portbench/loops/serve_marked.py": '''
from portbench.loops.serve_closed import Loop as _Serve


class Loop(_Serve):
    def describe(self):
        return "mode serve_marked; " + super().describe()
''',
    "portbench/reference/pp_marked.py": '''
from portbench.reference import pointpillars as _pp

CALLS = []
output_stride = _pp.output_stride


def forward(*args, **kw):
    CALLS.append(args[0].shape[0])
    return _pp.forward(*args, **kw)
''',
    "portbench/counters/pp_marked.py": '''
from portbench.counters import pointpillars as _pp

CALLS = []


def count(*args):
    CALLS.append(1)
    return _pp.count(*args)
''',
}


def add_marked_cell(root: Path) -> None:
    """Add the ``marked`` cell, which runs the tiny configuration under a
    new loop mode, reference model and counter: files and entries
    alone."""
    for rel, text in NEW_FILES.items():
        (root / rel).write_text(text.lstrip())
    with open(root / "portbench/configs/pp_tiny.json") as f:
        conf = json.load(f)
    conf.update(name="pp_marked", reference="pp_marked",
                counters="pp_marked")
    with open(root / "portbench/configs/pp_marked.json", "w") as f:
        json.dump(conf, f)
    with open(root / "portbench/traffic/tiny_b4.json") as f:
        mix = json.load(f)
    mix["mode"] = "serve_marked"
    with open(root / "portbench/traffic/marked_b4.json", "w") as f:
        json.dump(mix, f)
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"].append({"name": "pp_marked", "source": "test",
                             "file": "portbench/configs/pp_marked.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": MARKED, "config": "pp_marked",
                               "traffic": "marked_b4", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and TINY in m["workloads"]:
            m["workloads"].append(MARKED)
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    # The trained snapshot the PointPillars configuration names.
    (root / "weights").symlink_to(ROOT / "weights")
    add_tiny_cell(root)
    add_marked_cell(root)
    add_trained_cell(root)
    return root
