"""The reader of the sparse convs' span, ``spconv_stream_ms``, on span
records made by hand: nothing without a ``spconv`` span, the summed
stream ms a request with them."""

from __future__ import annotations

import json

import pytest

from portbench.harness import spec

from .conftest import ROOT

NAME = "spconv_stream_ms"


def _span(name, stream_ms=None):
    return {"name": name, "stream_ms": stream_ms}


@pytest.fixture
def record(monkeypatch):
    from lisec_tpu_torch.utils import profiling
    held = []
    monkeypatch.setattr(profiling, "spans", lambda: list(held))
    return held


def test_the_metric_is_listed_for_the_two_sparse_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in bench["per_layer"]}[NAME]
    assert entry["source"] == "program_span"
    assert entry["layer"] == "kernels"
    assert entry["moves"] == "latency_p95_ms"
    assert entry["workloads"] == ["second_serve_b8", "centerpoint_serve_b4"]
    assert spec.load_metric(NAME).LAYER == entry["layer"]


@pytest.mark.parametrize("names", [
    [], ["infer", "predict.forward", "encoder", "rulebook", "infer"]])
def test_without_the_conv_span_the_reader_finds_nothing(record, names):
    record.extend(_span(n, 1.0) for n in names)
    assert spec.load_metric(NAME).read({}) is None


def test_with_the_conv_spans_the_reader_sums_them_a_request(record):
    record.extend([_span("infer", 90.0), _span("encoder", 40.0),
                   _span("spconv", 0.5), _span("spconv", 1.5),
                   _span("infer", 80.0), _span("spconv", 1.0),
                   _span("rulebook", 3.0)])
    assert spec.load_metric(NAME).read({}) == pytest.approx(1.5)
