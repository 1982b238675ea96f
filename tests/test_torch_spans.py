"""The port's spans (``lisec_tpu_torch/utils/profiling.py``) on the CPU.

Off (no profiler recording) a span records nothing and enters no
``record_function``. Under ``torch.profiler`` the spans nest with their
parent and request ids, and their ``lisec.*`` names are
``user_annotation`` events of the Chrome trace. A served request of the
tiny PointPillars and SECOND configurations records the serving path's
span tree, one ``nms.round`` a round of the NMS loop and one
``rulebook`` a rulebook built, each counted here independently; and its
outputs are bit-equal with recording on and off.
"""

import json
import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lisec_tpu_torch
from lisec_tpu_torch.data.collate import make_batches
from lisec_tpu_torch.data.wire import pack_points_q16
from lisec_tpu_torch.models import second as second_mod
from lisec_tpu_torch.ops import nms as nms_mod
from lisec_tpu_torch.utils import profiling
from lisec_tpu_torch.utils.profiling import clear_spans, span, spans, trace

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ["pointpillars_tiny", "second_tiny"]
OUTPUT_KEYS = ("boxes", "scores", "labels", "valid")


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture
def fresh():
    clear_spans()
    yield
    clear_spans()


@pytest.fixture
def counted_ranges(monkeypatch):
    """How many ``record_function`` ranges the spans create."""
    calls = []
    real = profiling._profiler.record_function

    def counting(name, *args, **kw):
        calls.append(name)
        return real(name, *args, **kw)
    monkeypatch.setattr(profiling._profiler, "record_function", counting)
    return calls


@pytest.fixture(scope="module")
def served():
    """(pipeline, packed batch) of each tiny detector on the CPU, two
    fixture clouds a batch."""
    out = {}
    for name in CONFIGS:
        cfg = lisec_tpu_torch.load_config(
            os.path.join(ROOT, "configs", f"{name}.yaml"))
        pipe = lisec_tpu_torch.build_model(cfg, device="cpu")
        batch = next(make_batches(pipe.make_dataset("val"), cfg.budget, 2,
                                  shuffle=False))
        out[name] = (pipe, batch)
    return out


@pytest.mark.parametrize("device", [None, "cpu"])
def test_off_records_nothing_and_enters_no_range(fresh, counted_ranges,
                                                 device):
    with span("outer", device):
        with span("inner", device):
            torch.ones(4).sum()
    assert spans() == [] and counted_ranges == []
    with _recording():
        with span("outer", device):
            pass
    assert counted_ranges == ["lisec.outer"]
    assert [s["name"] for s in spans()] == ["outer"]


@pytest.mark.parametrize("name", CONFIGS)
def test_off_serving_records_nothing(served, fresh, counted_ranges, name):
    pipe, batch = served[name]
    pipe.infer_packed(pack_points_q16(batch["points"], batch["point_mask"]))
    assert spans() == [] and counted_ranges == []


def test_spans_nest_with_parent_and_request_ids(fresh, tmp_path):
    with _recording() as prof:
        for _ in range(2):
            with span("a"):
                with span("b", "cpu"):
                    with span("c"):
                        torch.ones(8).sum()
                with span("d"):
                    pass
    rec = spans()
    assert [s["name"] for s in rec] == ["a", "b", "c", "d"] * 2
    by_id = {s["id"]: s for s in rec}
    for i in (0, 4):
        a, b, c, d = rec[i:i + 4]
        assert a["parent"] is None
        assert b["parent"] == a["id"] and d["parent"] == a["id"]
        assert c["parent"] == b["id"]
        assert {s["request"] for s in (a, b, c, d)} == {a["request"]}
        for s in (a, b, c, d):
            assert s["start_ns"] <= s["end_ns"]
            if s["parent"] is not None:
                p = by_id[s["parent"]]
                assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                    <= p["end_ns"]
        assert b["stream_ms"] == pytest.approx(
            (b["end_ns"] - b["start_ns"]) * 1e-6)
        assert a["stream_ms"] is None and c["stream_ms"] is None
    assert rec[0]["request"] != rec[4]["request"]
    assert len({s["id"] for s in rec}) == len(rec)

    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = Counter(e["name"] for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith(profiling.PREFIX))
    assert names == {"lisec.a": 2, "lisec.b": 2, "lisec.c": 2, "lisec.d": 2}


def test_wire_pack_records_one_span_a_pack(fresh, tmp_path):
    """The compiled pack still opens ``wire.pack`` around the whole call:
    one root span, and one ``lisec.wire.pack`` range in the trace, a
    pack."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(-5, 5, (3, 64, 4)).astype(np.float32)
    mask = np.arange(64)[None, :] < np.array([[64], [9], [0]])
    with _recording() as prof:
        for _ in range(3):
            pack_points_q16(pts, mask)
    rec = spans()
    assert [s["name"] for s in rec] == ["wire.pack"] * 3
    assert all(s["parent"] is None and s["stream_ms"] is None for s in rec)
    assert len({s["request"] for s in rec}) == 3
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = Counter(e["name"] for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith(profiling.PREFIX))
    assert names == {"lisec.wire.pack": 3}


def test_trace_writes_the_spans_it_recorded(fresh, tmp_path):
    with _recording():
        with span("before"):
            pass
    with trace(str(tmp_path / "prof")):
        with span("inside", "cpu"):
            torch.ones(8).sum()
    with open(tmp_path / "prof" / "spans.json") as f:
        written = json.load(f)
    assert [s["name"] for s in written] == ["inside"]
    assert written[0]["stream_ms"] >= 0.0
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert [s["name"] for s in spans()] == ["before", "inside"]


def _tree(rec):
    """{span name: Counter of its children's names}."""
    by_id = {s["id"]: s for s in rec}
    tree = {}
    for s in rec:
        if s["parent"] is not None:
            tree.setdefault(by_id[s["parent"]]["name"], Counter())[
                s["name"]] += 1
    return tree


@pytest.mark.parametrize("name", CONFIGS)
def test_served_request_records_the_span_tree(served, fresh, monkeypatch,
                                              name):
    pipe, batch = served[name]
    pairs, builds = [], []
    real_iou = nms_mod._pair_iou
    real_build = second_mod.build_scatter_rulebook

    def pair_iou(*a):
        pairs.append(1)
        return real_iou(*a)

    def build(*a, **kw):
        builds.append(1)
        return real_build(*a, **kw)
    monkeypatch.setattr(nms_mod, "_pair_iou", pair_iou)
    monkeypatch.setattr(second_mod, "build_scatter_rulebook", build)
    with _recording():
        packed = pack_points_q16(batch["points"], batch["point_mask"])
        pipe.infer_packed(packed)
    rec = spans()
    roots = [s for s in rec if s["parent"] is None]
    assert [s["name"] for s in roots] == ["wire.pack", "infer"]
    assert roots[0]["request"] != roots[1]["request"]
    assert {s["request"] for s in rec[1:]} == {roots[1]["request"]}

    rounds = len(pairs) // 2      # two IoU batches a round
    assert rounds >= 1 and len(pairs) == 2 * rounds
    tree = _tree(rec)
    assert tree["infer"] == Counter(
        ["wire.h2d", "wire.unpack", "predict.forward", "predict.decode",
         "nms"])
    assert tree["nms"] == Counter({"nms.round": rounds, "nms.wait": 1})
    assert tree["nms.round"] == Counter({"nms.wait": rounds})
    n_rulebooks = sum(s["name"] == "rulebook" for s in rec)
    assert n_rulebooks == len(builds)
    if name == "second_tiny":
        assert n_rulebooks >= 2
        assert tree["predict.forward"] == Counter({"rulebook": len(builds)})
    else:
        assert n_rulebooks == 0 and "predict.forward" not in tree
    for s in rec:
        device = s["name"] not in ("wire.pack", "infer", "nms.round",
                                   "nms.wait")
        assert (s["stream_ms"] is not None) == device, s["name"]


@pytest.mark.parametrize("select", ["topk", "scan"])
@pytest.mark.parametrize("class_parallel", [0, 3])
@pytest.mark.parametrize("k_near", [0, 8])
def test_nms_rounds_are_the_loops_rounds(fresh, monkeypatch, select,
                                         class_parallel, k_near):
    """Clustered random boxes over three classes, so NMS suppresses and
    runs several rounds; on and off give equal outputs."""
    g = torch.Generator().manual_seed(7 + class_parallel + k_near)
    b, a = 2, 96
    centres = torch.rand(b, 6, 2, generator=g) * 40
    pick = torch.randint(0, 6, (b, a), generator=g)
    xy = torch.gather(centres, 1, pick[..., None].expand(-1, -1, 2)) \
        + torch.randn(b, a, 2, generator=g) * 0.4
    size = 1.5 + torch.rand(b, a, 3, generator=g)
    yaw = torch.rand(b, a, 1, generator=g) * 3.14
    boxes = torch.cat([xy, torch.zeros(b, a, 1), size, yaw], dim=-1)
    scores = torch.rand(b, a, generator=g)
    labels = torch.randint(0, 3, (b, a), generator=g)
    kw = dict(iou_threshold=0.3, score_threshold=0.05, nms_pre=64,
              nms_post=24, block=4, k_near=k_near, select=select,
              class_parallel=class_parallel)
    off = nms_mod.rotated_nms(boxes, scores, labels, **kw)
    pairs = []
    real = nms_mod._pair_iou

    def pair_iou(*args):
        pairs.append(1)
        return real(*args)
    monkeypatch.setattr(nms_mod, "_pair_iou", pair_iou)
    with _recording():
        on = nms_mod.rotated_nms(boxes, scores, labels, **kw)
    names = Counter(s["name"] for s in spans())
    assert names["nms.round"] == len(pairs) // 2 > 1
    assert names["nms.wait"] == names["nms.round"] + 1
    assert names["nms"] == 1
    for x, y in zip(off, on):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", CONFIGS)
def test_outputs_bit_equal_with_recording_on_and_off(served, fresh, name):
    pipe, batch = served[name]
    packed = pack_points_q16(batch["points"], batch["point_mask"])
    off = pipe.infer_packed(packed)
    with _recording():
        on = pipe.infer_packed(pack_points_q16(batch["points"],
                                               batch["point_mask"]))
    assert spans()
    for k in OUTPUT_KEYS:
        assert off[k].dtype == on[k].dtype, k
        np.testing.assert_array_equal(off[k].numpy(), on[k].numpy(),
                                      err_msg=k)
