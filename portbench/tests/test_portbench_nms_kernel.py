"""The reader of the NMS kernel's span, ``nms_kernel_stream_ms``, on
span records made by hand: nothing without an ``nms.kernel`` span, the
mean stream ms a request with them."""

from __future__ import annotations

import json

import pytest

from portbench.harness import spec

from .conftest import ROOT

NAME = "nms_kernel_stream_ms"


def _span(name, stream_ms=None):
    return {"name": name, "stream_ms": stream_ms}


@pytest.fixture
def record(monkeypatch):
    from lisec_tpu_torch.utils import profiling
    held = []
    monkeypatch.setattr(profiling, "spans", lambda: list(held))
    return held


def test_the_metric_is_listed_for_the_three_serving_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in bench["per_layer"]}[NAME]
    assert entry["source"] == "program_span"
    assert entry["layer"] == "post-processing"
    assert entry["moves"] == "latency_p95_ms"
    assert entry["workloads"] == ["pp_serve_b32", "second_serve_b8",
                                  "centerpoint_serve_b4"]


@pytest.mark.parametrize("names", [
    [], ["infer", "nms", "nms.round", "nms.wait", "infer", "nms"]])
def test_without_the_kernel_span_the_reader_finds_nothing(record, names):
    record.extend(_span(n, 1.0) for n in names)
    assert spec.load_metric(NAME).read({}) is None


def test_with_the_kernel_span_the_reader_gives_the_mean_a_request(record):
    record.extend([_span("infer", 90.0), _span("nms", 2.0),
                   _span("nms.kernel", 0.5), _span("infer", 80.0),
                   _span("nms", 1.5), _span("nms.kernel", 0.75),
                   _span("nms.kernel", 0.25)])
    assert spec.load_metric(NAME).read({}) == pytest.approx(0.75)
