"""One run of one cell: set-up, window, metrics, the reference's check and
the result line.

The loop that the cell's traffic mix names (``portbench/loops/<mode>.py``)
does the work: ``Loop(cell, seed, device)`` with ``setup()``,
``stages``, ``window(seconds, traced)``, ``attempted``, ``end_to_end()``,
``describe()``, ``context()`` (what the per-layer readers read),
``release()``, ``check()`` (the numbers compared with the configuration's
``limits``) and ``malformed()``.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from portbench.harness import device as devmod
from portbench.harness import guard
from portbench.harness.spec import ROOT, load_cell, load_metric


def _metric(value, unit) -> Dict:
    return {"value": float(value), "unit": unit}


def run_cell(name: str, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", t_start: Optional[float] = None,
             root: Path = ROOT, loop_hook=None) -> Optional[Dict]:
    """The result line's object, or None (with the cause on standard
    error) where the run may print no result. ``loop_hook(loop)``, run
    after set-up, lets a test break the timed path under the loop."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(name, root)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        devmod.require_cards(cell.chips)
    loop = cell.loop(cell, seed, device)
    t_setup = time.perf_counter()
    loop.setup()
    setup_s = time.perf_counter() - t_start
    if cuda:
        # The program's peak in the window, not a seed draw's calibration
        # in the reference during set-up.
        for i in range(cell.chips):
            torch.cuda.reset_peak_memory_stats(i)
    if loop_hook is not None:
        loop_hook(loop)
    print(f"set-up: {setup_s:.3f} s, before the loop "
          f"{t_setup - t_start:.3f} s, "
          + ", ".join(f"{k} {v:.3f}" for k, v in loop.stages.items()),
          file=sys.stderr)
    loop.window(seconds, traced)
    if cuda:
        torch.cuda.synchronize()
        peak = max(torch.cuda.max_memory_allocated(i)
                   for i in range(cell.chips))
    else:
        peak = 0
    e2e = dict(loop.end_to_end(), setup_s=setup_s)
    print(loop.describe(), file=sys.stderr)
    ctx = loop.context() if traced else None
    loop.release()
    numbers = loop.check()
    limits = cell.config["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    failed = loop.malformed()
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())

    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = load_metric(m["name"], root).read(ctx)
            if value is not None:
                metrics[m["name"]] = _metric(value, m["unit"])
    else:
        metrics = {m["name"]: _metric(e2e[m["name"]], m["unit"])
                   for m in cell.end_to_end}

    found = guard.forbidden_modules()
    if found:
        print(f"portbench: no result: loaded {found}", file=sys.stderr)
        return None
    if cuda:
        dev = devmod.describe(cell.chips, peak)
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    result = {"correct": bool(correct), "attempted": loop.attempted,
              "failed": int(failed), "metrics": metrics, "device": dev}
    if traced:
        t = ctx["trace"]
        dev["busy_s"] = float(t.get("busy_s", 0.0))
        dev["window_s"] = float(t.get("window_s", 0.0))
        result["breakdown"] = {"device_ops": t.get("device_ops", []),
                               "idle_gaps": t.get("idle_gaps", [])}
    result["checks"] = checks
    print(f"correct: {result['correct']}, malformed requests: {failed}",
          file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return result
