"""Reading a ``torch.profiler`` trace of the traced window.

The profiler's Chrome trace is read for: the device's busy time (the
union of kernel, copy and set intervals inside the window), each device
operation's total time by name, and the idle gaps on the device named by
what the host was doing then (the innermost host event that covers the
gap's middle). The window runs from the first to the end of the last
``portbench.request`` (or ``portbench.step``) annotation.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
WINDOW_NAMES = ("portbench.request", "portbench.step")


def export_events(prof) -> List[Dict]:
    """The profile's trace events (exported to a temporary file, read,
    and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return data["traceEvents"] if isinstance(data, dict) else data


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events: List[Dict], top: int = 10) -> Dict:
    """busy_s, window_s, per-kernel seconds and the breakdown lists."""
    marks = [e for e in events if e.get("ph") == "X"
             and e.get("name") in WINDOW_NAMES]
    if not marks:
        return {}
    w0 = min(e["ts"] for e in marks)
    w1 = max(e["ts"] + e["dur"] for e in marks)
    dev, by_name = [], defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        dev.append((a, b))
        by_name[e["name"]] += (b - a) * 1e-6
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6

    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in HOST_CATS and e.get("dur", 0) > 0),
                  key=lambda x: x[0])
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label, best = "host: no traced call", None
        hi = bisect.bisect_right(starts, mid)
        for i in range(hi - 1, max(hi - 4000, 0) - 1, -1):
            h = host[i]
            if mid < h[1] and (best is None or h[1] - h[0] < best):
                best, label = h[1] - h[0], h[2]
        gaps[label] += (b - a) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_s,
        "marks": len(marks),
        "device_s_by_name": dict(by_name),
        "device_ops": sorted(([k[:160], v] for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([k[:160], v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:top],
    }
