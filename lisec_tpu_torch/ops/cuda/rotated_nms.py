"""Rotated NMS's block-greedy rounds on Hopper: every round of every
stream in one launch, with no round issued and no wait by the host.

``run_streams(alive, top_scores, top_boxes, top_labels, half_diag, ...)``
is ``ops/nms.py::_run_streams``: S independent streams of P candidates
sorted by score, each run to its end by block-greedy rounds, giving
``out_idx`` (S, post) int64 candidate slots and ``out_valid`` (S, post)
bool. The kernel computes exactly that function (``csrc/rotated_nms.cu``
states it round by round); ``rotated_nms`` keeps its preselect, gathers
and per-stream merge in torch around it.

No TPU kernel is replaced: the JAX package runs NMS as XLA code, a
``while_loop`` under ``vmap`` (``lisec_tpu/ops/nms.py::rotated_nms``).
The plain version issues a dozen small torch ops and two batches of
elementwise IoU a round, then waits for the card to learn whether
another round runs; on the card that is milliseconds of host issue for
microseconds of work.

Bound on the card: the function reads each stream's candidates once
(boxes, key, half-diagonal, score and alive flag) and writes its outputs
once, ``S P (28 + 4 + 4 + 1 + key bytes) + 9 S post`` bytes
(``bound_bytes``): 1.38 MB, 0.41 us at 3.35 TB/s, for PointPillars' 32
streams of 1,024. Its IoUs (one per member pair in a block, one per emitted member
and near candidate) depend on the data and are a few thousand a stream.
The kernel is bound by the rounds' dependent steps, not by bytes or
operations.

Design: one block of 256 threads a stream (8-32 blocks at the
benchmark's shapes, one wave on 132 SMs). The stream's boxes,
half-diagonals and keys are staged in shared memory with one alive bit a
candidate (140,864 bytes at 3,000 candidates and int64 keys); a stream
too large for the card's shared memory is refused. Each round runs in
phases separated by barriers: the block by a warp's popcount scan of the
alive words, the in-block IoUs one thread a pair, the emissions in one
thread over 32-bit suppression masks, then each emitted member's circle
hits (counted and listed in one pass; where they exceed ``k_near``, a
radix select over the bits of d2 picks the nearest, ties by index) and
their IoUs one thread a pair, clearing alive bits. The pair IoU is
``csrc/rotated_iou.cuh``, written in ``rotated_iou_bev``'s f32 operation
order and built with ``-fmad=false``; its three 24-wide sums take a
stated order, so an IoU may differ from torch's by up to
``IOU_SUM_ORDER_TOL`` and a keep set only where a pair's IoU lies that
close to the threshold. ``select`` does not reach the kernel: "topk"
and "scan" pick the same block.

On CPU tensors ``run_streams`` computes the plain version
``ops/nms.py::_run_streams``; on CUDA tensors it launches the kernel, in
the span ``nms.kernel``, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from lisec_tpu_torch.ops.cuda import build
from lisec_tpu_torch.utils.profiling import span

# Launches of the CUDA kernel since import.
LAUNCHES = 0

KERNEL_INFO = {
    "name": "rotated_nms",
    "route": "cuda",
    "source": "lisec_tpu_torch/csrc/rotated_nms.cu",
    "replaces": "none: XLA's while_loop in lisec_tpu/ops/nms.py::"
                "rotated_nms",
}

# The most members a round's block may hold (one 32-bit mask).
MAX_BLOCK = 32
# |IoU - rotated_iou_bev's| that the kernel's sum order allows
# (``kIouSumOrderTol`` in ``csrc/rotated_iou.cuh``).
IOU_SUM_ORDER_TOL = 2e-6
# The entry's code for a stream too large for shared memory.
_DOES_NOT_FIT = -1
_KEY_DTYPES = (torch.int32, torch.int64)


def bound_bytes(s: int, p: int, post: int, key_bytes: int) -> int:
    """Bytes the function reads and writes once: boxes (7 f32), half
    diagonal, score, alive flag and key a candidate, then int64 slots
    and bool flags a kept box."""
    return s * p * (28 + 4 + 4 + 1 + key_bytes) + s * post * 9


def _refuse(alive, top_scores, top_boxes, top_labels, half_diag, block,
            k_near, full, select, nms_post):
    """Raise the ValueError that says why ``_check`` refused."""
    if alive.dtype != torch.bool or alive.dim() != 2:
        raise ValueError(f"alive must be (S, P) bool, got "
                         f"{tuple(alive.shape)} {alive.dtype}")
    s, p = alive.shape
    for name, a, dtypes in (("top_scores", top_scores, (torch.float32,)),
                            ("top_labels", top_labels, _KEY_DTYPES),
                            ("half_diag", half_diag, (torch.float32,))):
        if a.dtype not in dtypes or a.shape != (s, p):
            raise ValueError(f"{name} must be ({s}, {p}) "
                             f"{' or '.join(map(str, dtypes))}, got "
                             f"{tuple(a.shape)} {a.dtype}")
    if top_boxes.dtype != torch.float32 or top_boxes.shape != (s, p, 7):
        raise ValueError(f"top_boxes must be ({s}, {p}, 7) float32, got "
                         f"{tuple(top_boxes.shape)} {top_boxes.dtype}")
    for name, a in (("top_scores", top_scores), ("top_boxes", top_boxes),
                    ("top_labels", top_labels), ("half_diag", half_diag)):
        if a.device != alive.device:
            raise ValueError(f"{name} is on {a.device}, alive on "
                             f"{alive.device}")
    if s < 1 or p < 1:
        raise ValueError(f"need S, P >= 1, got {s}, {p}")
    if not 1 <= block <= min(MAX_BLOCK, p):
        raise ValueError(f"block must be in [1, min({MAX_BLOCK}, P = {p})], "
                         f"got {block}")
    if not full and not 1 <= k_near < p:
        raise ValueError(f"k_near must be in [1, P = {p}) outside full "
                         f"mode, got {k_near}")
    if select not in ("topk", "scan"):
        raise ValueError(f"select must be 'topk' or 'scan', got {select!r}")
    if nms_post < 0:
        raise ValueError(f"nms_post must be >= 0, got {nms_post}")
    raise ValueError("alive, top_scores, top_boxes, top_labels and "
                     "half_diag must be contiguous")


def _check(alive, top_scores, top_boxes, top_labels, half_diag, block,
           k_near, full, select, nms_post):
    if not (alive.dtype == torch.bool and alive.dim() == 2
            and top_scores.dtype == torch.float32
            and top_boxes.dtype == torch.float32
            and top_labels.dtype in _KEY_DTYPES
            and half_diag.dtype == torch.float32
            and top_scores.shape == alive.shape
            and top_labels.shape == alive.shape
            and half_diag.shape == alive.shape
            and top_boxes.shape == (*alive.shape, 7)
            and alive.numel() > 0
            and 1 <= block <= min(MAX_BLOCK, alive.shape[1])
            and (full or 1 <= k_near < alive.shape[1])
            and select in ("topk", "scan") and nms_post >= 0
            and all(a.device == alive.device and a.is_contiguous()
                    for a in (alive, top_scores, top_boxes, top_labels,
                              half_diag))):
        _refuse(alive, top_scores, top_boxes, top_labels, half_diag, block,
                k_near, full, select, nms_post)


_nms_fn = None


def _launch(alive, top_scores, top_boxes, top_labels, half_diag, *,
            iou_threshold, score_threshold, block, k_near, full, nms_post):
    global LAUNCHES, _nms_fn
    if _nms_fn is None:
        p = ctypes.c_void_p
        ll = ctypes.c_longlong
        _nms_fn = build.bind(
            "rotated_nms", "lisec_rotated_nms",
            [p] * 7 + [ll] * 7 + [ctypes.c_float, ctypes.c_float, p])
    s, pre = alive.shape
    out_idx = alive.new_empty((s, nms_post), dtype=torch.int64)
    out_valid = alive.new_empty((s, nms_post), dtype=torch.bool)
    with span("nms.kernel", alive.device):
        err = _nms_fn(alive.data_ptr(), top_scores.data_ptr(),
                      top_boxes.data_ptr(), top_labels.data_ptr(),
                      half_diag.data_ptr(), out_idx.data_ptr(),
                      out_valid.data_ptr(), s, pre, block,
                      0 if full else k_near, int(full), nms_post,
                      int(top_labels.dtype == torch.int64), iou_threshold,
                      score_threshold, build.stream_of(alive))
    if err == _DOES_NOT_FIT:
        raise ValueError(f"a stream of {pre} candidates does not fit the "
                         f"card's shared memory")
    if err != 0:
        raise RuntimeError(f"rotated_nms kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1
    return out_idx, out_valid


def run_streams(alive, top_scores, top_boxes, top_labels, half_diag, *,
                iou_threshold, score_threshold, block, k_near, full, select,
                nms_post):
    """Block-greedy NMS of S independent streams: ``_run_streams``'s
    arguments and outputs (out_idx (S, post) int64, out_valid (S, post)
    bool). CPU tensors take the plain version; CUDA tensors one kernel
    launch."""
    _check(alive, top_scores, top_boxes, top_labels, half_diag, block,
           k_near, full, select, nms_post)
    kw = dict(iou_threshold=iou_threshold, score_threshold=score_threshold,
              block=block, k_near=k_near, full=full, nms_post=nms_post)
    if not alive.is_cuda:
        from lisec_tpu_torch.ops import nms
        return nms._run_streams(alive, top_scores, top_boxes, top_labels,
                                half_diag, select=select, **kw)
    return _launch(alive, top_scores, top_boxes, top_labels, half_diag,
                   **kw)

