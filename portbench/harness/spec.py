"""What a run measures, found by name from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's file ``portbench/configs/<config>.json`` holds
the configuration as it is run, its weights and limits, and names its
plain reference ``portbench/reference/<reference>.py`` and its work
counter ``portbench/counters/<counters>.py``. The traffic mix
``portbench/traffic/<traffic>.json`` holds the parameters that the loop
``portbench/loops/<mode>.py`` reads, and names its scene generator
``portbench/traffic/<scenes>.py``. Each per-layer metric is a reader of
its own, ``portbench/metrics/<name>.py``, with ``LAYER``, ``UNIT``,
``MOVES``, ``SOURCE`` and ``read(ctx)``, reported in the cells that its
``workloads`` in ``BENCHMARK.json`` list. Adding a cell, a mix, a loop, a
model, a configuration or a metric is adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict            # the configuration file's JSON
    traffic_name: str
    traffic: Dict           # the traffic mix's parameters
    end_to_end: List[Dict]
    per_layer: List[Dict]
    run_seconds: int
    root: Path = field(default=ROOT)

    @property
    def program_config(self) -> Dict:
        """The program's configuration dict, as it is run."""
        return self.config["program_config"]

    @property
    def reference(self) -> ModuleType:
        """The configuration's plain reference model."""
        return load_module("reference", self.config["reference"], self.root)

    @property
    def counters(self) -> ModuleType:
        """The configuration's work counter (FLOPs and kernels' least
        times at a batch's own inputs)."""
        return load_module("counters", self.config["counters"], self.root)

    @property
    def loop(self) -> type:
        """The loop class that the traffic mix's ``mode`` names."""
        return load_module("loops", self.traffic["mode"], self.root).Loop


def _read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=_read_json(root / conf["file"]),
        traffic_name=w["traffic"],
        traffic=_read_json(root / "portbench" / "traffic"
                           / f"{w['traffic']}.json"),
        end_to_end=e2e, per_layer=per_layer,
        run_seconds=int(bench["run_seconds"]), root=root)


_MODULES: Dict[Path, ModuleType] = {}


def load_module(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """The module ``<root>/portbench/<kind>/<name>.py``, loaded from its
    file (once), so that a benchmark's own files are the ones run."""
    path = root / "portbench" / kind / f"{name}.py"
    if path not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{name.replace('.', '_')}", path)
        if spec is None or spec.loader is None or not path.is_file():
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def load_metric(name: str, root: Path = ROOT) -> ModuleType:
    """The reader module ``portbench/metrics/<name>.py``."""
    return load_module("metrics", name, root)
