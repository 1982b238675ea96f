"""The readers of the program's spans on the CPU: a traced run of the
``tiny`` cell reports each of them, and against a program that records
no spans each finds nothing and raises nothing."""

from __future__ import annotations

import json
import math

import pytest

from portbench.harness import spec
from portbench.harness.runner import run_cell

from .conftest import ROOT, TINY

SPAN_METRICS = ["wire_pack_ms", "wire_unpack_ms", "forward_stream_ms",
                "decode_stream_ms", "nms_stream_ms", "nms_rounds",
                "rulebook_stream_ms"]


def test_span_metrics_are_listed():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    sources = {m["name"]: m["source"] for m in bench["per_layer"]}
    assert all(sources[n] == "program_span" for n in SPAN_METRICS)


def test_traced_tiny_run_reports_every_span_metric(tiny_root):
    from lisec_tpu_torch.utils.profiling import clear_spans, spans
    clear_spans()
    r = run_cell(TINY, 2**31 + 5, 0.5, True, device="cpu", root=tiny_root)
    listed = [m["name"] for m in spec.load_cell(TINY, tiny_root).per_layer
              if m["name"] in SPAN_METRICS]
    assert listed == SPAN_METRICS[:-1]
    for name in listed:
        value = r["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0.0, name
    assert r["metrics"]["nms_rounds"]["value"] >= 1
    # The record holds the traced requests alone: one pack and one
    # ``infer`` a request.
    rec = spans()
    mix = json.loads((tiny_root / "portbench/traffic/tiny_b4.json")
                     .read_text())
    roots = [s["name"] for s in rec if s["parent"] is None]
    assert roots == ["wire.pack", "infer"] * mix["trace_requests"]
    rounds = sum(s["name"] == "nms.round" for s in rec)
    assert r["metrics"]["nms_rounds"]["value"] == pytest.approx(
        rounds / mix["trace_requests"])
    clear_spans()


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_without_spans_in_the_program_a_reader_finds_nothing(
        name, monkeypatch):
    from lisec_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    assert spec.load_metric(name).read({}) is None
