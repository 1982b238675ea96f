"""The NMS rounds' kernel wrapper (``ops/cuda/rotated_nms.py``) on the CPU.

On CPU tensors the wrapper computes the plain version
``ops/nms.py::_run_streams`` and launches nothing; it refuses what the
kernel does not take on any device. The kernel's pair IoU
(``csrc/rotated_iou.cuh``), built for the host by g++ without
floating-point contraction, is held against ``rotated_iou_bev`` within
the tolerance that its stated sum order allows. The kernel itself runs
only on the card: ``chip_smoke.py --nms`` holds it against the plain
version there.
"""

from __future__ import annotations

import ctypes
import math

import pytest
import torch

from lisec_tpu_torch.ops import nms as nms_mod
from lisec_tpu_torch.ops.cuda import build
from lisec_tpu_torch.ops.cuda import rotated_nms as nk
from lisec_tpu_torch.ops.rotated_iou import rotated_iou_bev


def _streams(seed, s, p, keys, key_dtype=torch.int64, spread=0.5):
    """S streams of P clustered candidates sorted by score (ties kept in
    index order), as ``rotated_nms`` hands them to the rounds."""
    g = torch.Generator().manual_seed(seed)
    centres = torch.rand(s, 5, 2, generator=g) * 30
    pick = torch.randint(0, 5, (s, p), generator=g)
    xy = torch.gather(centres, 1, pick[..., None].expand(-1, -1, 2)) \
        + torch.randn(s, p, 2, generator=g) * spread
    size = 1.0 + torch.rand(s, p, 3, generator=g) * 3
    yaw = (torch.rand(s, p, 1, generator=g) - 0.5) * 2 * math.pi
    boxes = torch.cat([xy, torch.zeros(s, p, 1), size, yaw], dim=-1)
    # Exact duplicates: equal distances and IoU 1.
    boxes[:, 1::4] = boxes[:, 0::4][:, :boxes[:, 1::4].shape[1]]
    scores = torch.round(torch.rand(s, p, generator=g) * 40) / 40
    scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 7))
    key = torch.randint(0, keys, (s, p), generator=g).to(key_dtype)
    half_diag = 0.5 * torch.hypot(boxes[..., 3], boxes[..., 4])
    return (scores > 0.1).contiguous(), scores.contiguous(), \
        boxes.contiguous(), key, half_diag


def _kw(block=16, k_near=8, full=False, select="topk", post=24, thr=0.3):
    return dict(iou_threshold=thr, score_threshold=0.1, block=block,
                k_near=k_near, full=full, select=select, nms_post=post)


@pytest.mark.parametrize("case", [
    dict(), dict(k_near=0, full=True), dict(block=4, k_near=3),
    dict(block=32, post=60, thr=0.5), dict(select="scan", thr=0.5),
    dict(key_dtype=torch.int32, keys=3), dict(block=1, k_near=1, post=5)])
def test_cpu_tensors_take_the_plain_version(case):
    case = dict(case)
    key_dtype = case.pop("key_dtype", torch.int64)
    keys = case.pop("keys", 2)
    args = _streams(5, 6, 96, keys, key_dtype)
    kw = _kw(**case)
    if kw["full"]:
        kw["k_near"] = 96
    before = nk.LAUNCHES
    got = nk.run_streams(*args, **kw)
    want = nms_mod._run_streams(*args, **kw)
    assert nk.LAUNCHES == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.bool
    assert int(want[1].sum()) > 6


def test_rotated_nms_on_the_cpu_launches_nothing():
    args = _streams(9, 2, 64, 3)
    boxes, scores, labels = args[2], args[1], args[3]
    before = nk.LAUNCHES
    out = nms_mod.rotated_nms(boxes, scores, labels, iou_threshold=0.3,
                              score_threshold=0.1, nms_pre=64, nms_post=16,
                              block=4, k_near=8, class_parallel=3)
    assert nk.LAUNCHES == before
    assert int(out.valid.sum()) > 4


def _bad(name):
    alive, scores, boxes, keys, hd = _streams(3, 2, 40, 2)
    kw = _kw()
    if name == "alive_float":
        alive = alive.float()
    elif name == "scores_f64":
        scores = scores.double()
    elif name == "boxes_nine_columns":
        boxes = torch.cat([boxes, boxes[..., :2]], dim=-1)
    elif name == "keys_int16":
        keys = keys.to(torch.int16)
    elif name == "half_diag_bf16":
        hd = hd.to(torch.bfloat16)
    elif name == "scores_shape":
        scores = scores[:, :-1]
    elif name == "scores_strided":
        scores = torch.stack([scores, scores], dim=-1)[..., 0]
    elif name == "boxes_strided":
        boxes = torch.cat([boxes, boxes[..., :2]], dim=-1)[..., :7]
    elif name == "block_zero":
        kw["block"] = 0
    elif name == "block_wide":
        kw["block"] = nk.MAX_BLOCK + 1
    elif name == "k_near_whole_stream":
        kw["k_near"] = 40
    elif name == "select":
        kw["select"] = "sorted"
    elif name == "post_negative":
        kw["nms_post"] = -1
    return (alive, scores, boxes, keys, hd), kw


@pytest.mark.parametrize("name", [
    "alive_float", "scores_f64", "boxes_nine_columns", "keys_int16",
    "half_diag_bf16", "scores_shape", "scores_strided", "boxes_strided",
    "block_zero", "block_wide", "k_near_whole_stream", "select",
    "post_negative"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(name):
    args, kw = _bad(name)
    with pytest.raises(ValueError):
        nk.run_streams(*args, **kw)


_IOU_FN = []


def host_pair_iou(a, b):
    """The kernel's pair IoU built for the host
    (``csrc/rotated_iou_host.cc``) on (N, 7) float32 CPU boxes."""
    if not _IOU_FN:
        _IOU_FN.append(build.bind(
            "rotated_iou_host", "lisec_rotated_iou_pairs",
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p]))
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty(a.shape[0], dtype=torch.float32)
    _IOU_FN[0](a.data_ptr(), b.data_ptr(), a.shape[0], out.data_ptr())
    return out


def _pairs(case, n, g):
    """n pairs of boxes of one family."""
    def rnd(m, far=0.0):
        xy = torch.rand(m, 2, generator=g) * 3 + far
        lwh = 0.5 + torch.rand(m, 3, generator=g) * 4
        yaw = (torch.rand(m, 1, generator=g) - 0.5) * 2 * math.pi
        return torch.cat([xy, torch.zeros(m, 1), lwh, yaw], dim=1)
    a = rnd(n, far=1e4 if case == "identical_far" else 0.0)
    if case == "random":
        return a, rnd(n)
    if case == "identical_far":
        return a, a.clone()
    b = a.clone()
    c, s = torch.cos(a[:, 6]), torch.sin(a[:, 6])
    if case == "touching":            # end to end along the heading
        b[:, 0] += a[:, 3] * c
        b[:, 1] += a[:, 3] * s
    elif case == "nested":            # inside whatever its turn
        side = torch.minimum(a[:, 3], a[:, 4])
        b[:, 3], b[:, 4] = 0.3 * side, 0.5 * side
        b[:, 6] += torch.rand(n, generator=g) * 3
    else:                             # near_threshold: IoU about 1/3
        b[:, 0] += 0.5 * a[:, 3] * c
        b[:, 1] += 0.5 * a[:, 3] * s
    return a, b


@pytest.mark.parametrize("case", ["random", "identical_far", "touching",
                                  "nested", "near_threshold"])
def test_kernel_pair_iou_matches_rotated_iou_bev(case):
    g = torch.Generator().manual_seed(11)
    a, b = _pairs(case, 20000, g)
    want = rotated_iou_bev(a, b)
    got = host_pair_iou(a, b)
    gap = (got - want).abs()
    assert float(gap.max()) <= nk.IOU_SUM_ORDER_TOL, float(gap.max())
    if case == "identical_far":
        assert float(got.min()) > 1 - 1e-6
    elif case == "touching":
        assert float(got.max()) < 1e-5
    elif case == "near_threshold":
        thr = 1.0 / 3.0
        flip = (got > thr) != (want > thr)
        assert bool(((want - thr).abs()[flip] <= nk.IOU_SUM_ORDER_TOL).all())
    elif case == "nested":            # the inner box's share of the outer
        share = b[:, 3] * b[:, 4] / (a[:, 3] * a[:, 4])
        assert torch.allclose(want, share, rtol=1e-5, atol=0)
    else:
        assert float(want.max()) > 0.3


def test_build_hash_covers_included_headers_and_source_flags(tmp_path,
                                                             monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "pair.cuh").write_text("// v1\n")
    (csrc / "rotated_nms.cu").write_text('#include "pair.cuh"\n')
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    first = build.library_path("rotated_nms")
    (csrc / "pair.cuh").write_text("// v2\n")
    assert build.library_path("rotated_nms") != first
    flags = build._compiler(csrc / "rotated_nms.cu")[1]
    assert "-fmad=false" in flags and flags[:len(build.NVCC_FLAGS)] == \
        build.NVCC_FLAGS
