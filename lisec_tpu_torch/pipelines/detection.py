"""Anchor-based 3D detection, PointPillars inference (port of
``lisec_tpu/pipelines/detection.py::PointPillarsPipeline``).

points + mask -> fused encoder -> backbone -> head -> score preselect ->
decode -> direction-bin yaw -> rotated NMS -> boxes/scores/labels/valid.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from lisec_tpu_torch.config import Config
from lisec_tpu_torch.models.pointpillars import PointPillarsFused
from lisec_tpu_torch.ops.boxes import decode_boxes
from lisec_tpu_torch.ops.nms import rotated_nms, top_k
from lisec_tpu_torch.pipelines.base import Pipeline
from lisec_tpu_torch.registry import register_model, register_pipeline
from lisec_tpu_torch.training.assigner import (
    DEFAULT_ANCHORS, AnchorConfig, generate_anchors)

register_model("pointpillars")(PointPillarsFused)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@register_pipeline("pointpillars")
class PointPillarsPipeline(Pipeline):
    OUTPUT_STRIDE = 2

    def __init__(self, cfg: Config, device="cuda", seed: int = 0):
        super().__init__(cfg, device)
        self.class_names = tuple(cfg.data.class_names) or ("Car",)
        self.num_classes = len(self.class_names)
        self.grid = cfg.voxel.grid_size                   # (nx, ny, nz)
        self.fmap = (self.grid[1] // self.OUTPUT_STRIDE,
                     self.grid[0] // self.OUTPUT_STRIDE)  # (ny, nx)
        p = cfg.model.params

        anchor_cfgs = []
        for name in self.class_names:
            base = DEFAULT_ANCHORS.get(name, DEFAULT_ANCHORS["Car"])
            over = p.get("anchors", {}).get(name, {})
            anchor_cfgs.append(AnchorConfig(
                tuple(over.get("size", base.size)),
                float(over.get("z_center", base.z_center)),
                float(over.get("pos_threshold", base.pos_threshold)),
                float(over.get("neg_threshold", base.neg_threshold))))
        anchors, _, _, _ = generate_anchors(
            anchor_cfgs, pc_range=cfg.voxel.point_cloud_range,
            feature_map_size=self.fmap)
        self.anchors = torch.from_numpy(anchors).to(self.device)

        # Random weights from the seed; load_weights_npz replaces them.
        model = self.build_model(cfg)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()
        self.nms_iou = float(p.get("nms_iou", 0.5))
        self.score_thr = float(p.get("score_threshold", 0.1))

    def build_model(self, cfg: Config) -> PointPillarsFused:
        p = cfg.model.params
        if not p.get("fused", True):
            raise NotImplementedError(
                "the voxel-buffer PointPillars path (fused: false) is not "
                "ported yet")
        return PointPillarsFused(
            num_classes=self.num_classes,
            grid_size=self.grid,
            voxel_size=tuple(cfg.voxel.voxel_size[:2]),
            pc_range=tuple(cfg.voxel.point_cloud_range),
            num_anchors_per_cell=self.num_classes * 2,
            pfn_filters=int(p.get("pfn_filters", 64)),
            backbone_layers=tuple(p.get("backbone_layers", [3, 5, 5])),
            backbone_filters=tuple(p.get("backbone_filters",
                                         [64, 128, 256])),
            backbone_strides=tuple(p.get("backbone_strides", [2, 2, 2])),
            backbone_up_strides=tuple(p.get("backbone_up_strides",
                                            [1, 2, 4])),
            backbone_up_filters=tuple(p.get("backbone_up_filters",
                                            [128, 128, 128])),
            dtype=_DTYPES[p.get("dtype", "float32")],
        )

    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        preds = self.model(batch["points"], batch["point_mask"])
        budget = self.cfg.budget

        # Preselect nms_pre candidates by score before any decode math.
        scores_all = torch.sigmoid(preds["cls"])               # (B, A, C)
        scores = scores_all.max(dim=-1).values
        npre = min(budget.nms_pre, scores.shape[1])
        _, idx = top_k(scores, npre)                           # (B, P)

        def take(x):
            return torch.gather(
                x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
        sel_scores_all = take(scores_all)
        boxes = decode_boxes(take(preds["box"]), self.anchors[idx])

        # Resolve yaw with the direction bin: mod(yaw, pi) selects the
        # in-half angle, the bin picks the half.
        dir_bin = take(preds["dir"]).argmax(dim=-1)
        yaw = torch.remainder(boxes[..., 6], math.pi)
        yaw = torch.where(dir_bin == 1, yaw, yaw - math.pi)
        boxes = torch.cat([boxes[..., :6], yaw[..., None]], dim=-1)

        sel_scores = sel_scores_all.max(dim=-1).values
        labels = sel_scores_all.argmax(dim=-1).to(torch.int32)

        nms = rotated_nms(
            boxes, sel_scores, labels,
            iou_threshold=self.nms_iou,
            score_threshold=self.score_thr,
            nms_pre=npre,
            nms_post=budget.nms_post,
            k_near=budget.nms_near,
            block=budget.nms_block,
            select=budget.nms_select,
            class_parallel=(self.num_classes
                            if budget.nms_class_parallel
                            and self.num_classes > 1 else 0))
        return {"boxes": nms.boxes, "scores": nms.scores,
                "labels": nms.labels, "valid": nms.valid}
