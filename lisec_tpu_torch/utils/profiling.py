"""Tracing (port of ``lisec_tpu/utils/profiling.py``) and the serving
path's spans.

``trace(log_dir)`` profiles a region with ``torch.profiler`` and writes a
Chrome / Perfetto trace, ``trace.json``, and the spans recorded in it,
``spans.json``.

``span(name)`` marks one stretch of the program's work. It records only
while a ``torch.profiler`` profile records; otherwise it is one flag
check. While it records, it

* opens a ``record_function("lisec.<name>")`` range, which the profiler's
  trace holds as a ``user_annotation`` on the kernels' clock;
* appends a record: ``name``, ``id``, ``parent`` (the span open around
  it on the same thread, or None), ``request`` (a span with no parent
  starts a new request; the spans under it inherit its id), and the host
  clock's ``start_ns`` and ``end_ns`` (``time.perf_counter_ns``);
* given a ``device``, also takes ``stream_ms``: CUDA events on the
  device's current stream at the start and the end, so the time the
  stream took from one to the other, idle included. The events are read
  when the record is (one synchronize). On the CPU, which runs
  synchronously, it is the host's duration.

``spans()`` returns the record, ``clear_spans()`` empties it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Tuple

import torch
from torch.autograd import profiler as _profiler

PREFIX = "lisec."

_RECORD: List[Dict] = []
# Closed spans whose stream time is still on the card: (record, device,
# start event, end event).
_PENDING: List[Tuple[Dict, torch.device, "torch.cuda.Event",
                     "torch.cuda.Event"]] = []
_LOCK = threading.Lock()
_IDS = itertools.count()
_REQUESTS = itertools.count()
_LOCAL = threading.local()


# The span while no profiler records: enters nothing.
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("rec", "range", "device", "start")

    def __init__(self, name: str, device):
        self.rec = {"name": name, "id": next(_IDS), "parent": None,
                    "request": None, "start_ns": None, "end_ns": None,
                    "stream_ms": None}
        self.device = None if device is None else torch.device(device)
        self.range = _profiler.record_function(PREFIX + name)
        self.start = None

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        rec = self.rec
        if stack:
            rec["parent"] = stack[-1]["id"]
            rec["request"] = stack[-1]["request"]
        else:
            rec["request"] = next(_REQUESTS)
        stack.append(rec)
        with _LOCK:
            _RECORD.append(rec)
        self.range.__enter__()
        if self.device is not None and self.device.type == "cuda":
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(self.device))
        rec["start_ns"] = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        rec = self.rec
        rec["end_ns"] = time.perf_counter_ns()
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            with _LOCK:
                _PENDING.append((rec, self.device, self.start, end))
        elif self.device is not None:
            rec["stream_ms"] = (rec["end_ns"] - rec["start_ns"]) * 1e-6
        self.range.__exit__(*exc)
        _LOCAL.stack.pop()
        return False


def span(name: str, device=None):
    """``with span("nms"):`` marks the block as the span ``lisec.nms``
    while a profiler records, and does nothing otherwise. With
    ``device`` (where the block's work runs) the record also holds the
    block's ``stream_ms``."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def spans() -> List[Dict]:
    """The spans recorded so far, in the order they started (copies).
    Reads the pending CUDA events first, after one synchronize."""
    with _LOCK:
        for dev in {d for _, d, _, _ in _PENDING}:
            torch.cuda.synchronize(dev)
        for rec, _, start, end in _PENDING:
            rec["stream_ms"] = start.elapsed_time(end)
        _PENDING.clear()
        return [dict(rec) for rec in _RECORD]


def clear_spans() -> None:
    """Empty the record."""
    with _LOCK:
        _RECORD.clear()
        _PENDING.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region, host and card: ``with trace('/tmp/profile'):
    step()`` writes ``log_dir/trace.json``, which Perfetto and
    ``chrome://tracing`` open, and ``log_dir/spans.json``, the spans that
    started inside the region (``spans()``'s records). The JAX package's
    ``create_perfetto_link`` uploads the trace to a web viewer; there is
    no counterpart here."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.perf_counter_ns()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump([s for s in spans() if s["start_ns"] >= t0], f)
