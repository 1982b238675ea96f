"""The benchmark's plain reference: float32 PyTorch and NumPy that import
nothing of the program under test, nor JAX.

``detections`` runs a detector's reference model (a module of this
folder that a configuration names, with ``forward`` and
``output_stride``) over a batch of clouds and returns, per cloud, every
anchor's decoded box, score and label and the greedy-NMS detections that
the configuration asks for.
"""

from __future__ import annotations

import contextlib
from types import ModuleType
from typing import Callable, Dict, List

import torch

from portbench.reference import detect


@contextlib.contextmanager
def exact_float32():
    """float32 products without TF32 inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@torch.no_grad()
def detections(model: ModuleType, points: torch.Tensor,
               counts: torch.Tensor, w: Dict, cfg: Dict,
               lowp: Callable = None) -> List[Dict]:
    """Per cloud of (B, N, 4) ``points``, through the reference ``model``:
    ``all`` (every anchor's box, score, label) and ``dets`` (greedy NMS
    output)."""
    kw = {} if lowp is None else {"lowp": lowp}
    with exact_float32():
        out = model.forward(points, counts, w, cfg, **kw)
    p = cfg["model"]["params"]
    budget = cfg["budget"]
    r = cfg["voxel"]["point_cloud_range"]
    vs = cfg["voxel"]["voxel_size"]
    s = model.output_stride(cfg)
    fmap = (int(round((r[4] - r[1]) / vs[1])) // s,
            int(round((r[3] - r[0]) / vs[0])) // s)
    anc = detect.anchors(cfg["data"]["class_names"], r, fmap,
                         points.device)
    result = []
    for i in range(points.shape[0]):
        probs = torch.sigmoid(out["cls"][i])
        scores, labels = probs.max(-1)
        boxes, edge, margin = detect.decode(out["box"][i], anc["boxes"],
                                            out["dir"][i])
        dets = detect.greedy_nms(
            boxes, scores, labels, iou_thr=float(p.get("nms_iou", 0.5)),
            score_thr=float(p.get("score_threshold", 0.1)),
            pre=int(budget["nms_pre"]), post=int(budget["nms_post"]),
            near=int(budget.get("nms_near", 0)))
        result.append({"all": {"boxes": boxes, "scores": scores,
                               "labels": labels, "edge": edge,
                               "dir_margin": margin},
                       "dets": dets})
    return result


def as_served(dets: Dict[str, torch.Tensor], post: int) -> Dict:
    """Detections in the served layout: ``post`` rows, ``valid`` first."""
    n = dets["scores"].shape[0]
    boxes = torch.zeros((post, 7))
    boxes[:n] = dets["boxes"].cpu()
    scores = torch.zeros((post,))
    scores[:n] = dets["scores"].cpu()
    labels = torch.full((post,), -1, dtype=torch.int32)
    labels[:n] = dets["labels"].cpu().int()
    valid = torch.arange(post) < n
    return {"boxes": boxes.numpy(), "scores": scores.numpy(),
            "labels": labels.numpy(), "valid": valid.numpy()}
