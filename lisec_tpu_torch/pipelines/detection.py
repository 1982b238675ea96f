"""Anchor-based 3D detection: PointPillars and SECOND (port of
``lisec_tpu/pipelines/detection.py::PointPillarsPipeline`` and
``SECONDPipeline``).

Inference: points + mask -> encoder (the fused pillar encoder; with
``model.params.fused: false`` voxelize + the pillar feature net + the
pillar scatter; for SECOND voxelize + mean-VFE + the sparse middle
encoder) -> backbone -> head ->
score preselect -> decode -> direction-bin yaw -> rotated NMS ->
boxes/scores/labels/valid. Training assigns targets on the device and
uses the focal / smooth-L1 with sin-difference / direction loss recipe.
Evaluation takes recall at BEV IoU 0.5 and KITTI AP over the val split.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from lisec_tpu_torch.config import Config
from lisec_tpu_torch.data.augment import GTSampler, augment_detection
from lisec_tpu_torch.data.kitti import KittiDetection
from lisec_tpu_torch.eval.detection import match_frame
from lisec_tpu_torch.eval.kitti_ap import collect_detections, kitti_ap
from lisec_tpu_torch.models.pointpillars import (
    PointPillars, PointPillarsFused)
from lisec_tpu_torch.models.second import SECONDNet
from lisec_tpu_torch.ops.boxes import decode_boxes
from lisec_tpu_torch.ops.nms import rotated_nms, top_k
from lisec_tpu_torch.ops.voxelize import voxelize_batch, voxelize_mean_batch
from lisec_tpu_torch.parallel.mesh import global_sum, world_size
from lisec_tpu_torch.pipelines.base import Pipeline
from lisec_tpu_torch.registry import register_model, register_pipeline
from lisec_tpu_torch.training.assigner import (
    DEFAULT_ANCHORS, AnchorConfig, assign_targets,
    assign_targets_windowed_batched, generate_anchors)
from lisec_tpu_torch.training.losses import (
    sigmoid_focal_loss, sin_difference, smooth_l1)

register_model("pointpillars")(PointPillarsFused)
register_model("second")(SECONDNet)

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
        anchors, acls, pos_t, neg_t = generate_anchors(
            anchor_cfgs, pc_range=cfg.voxel.point_cloud_range,
            feature_map_size=self.fmap)
        dev = self.device
        self.anchors = torch.from_numpy(anchors).to(dev)
        self.anchor_classes = torch.from_numpy(acls).to(dev)
        self.pos_thr = torch.from_numpy(pos_t).to(dev)
        self.neg_thr = torch.from_numpy(neg_t).to(dev)
        self.class_sizes = torch.tensor([c.size for c in anchor_cfgs],
                                        dtype=torch.float32, device=dev)
        self.class_z = torch.tensor([c.z_center for c in anchor_cfgs],
                                    dtype=torch.float32, device=dev)

        # Random weights from the seed; load_weights_npz replaces them and
        # init_state(seed) draws them anew for training.
        model = self.build_model(cfg)
        model.reset_parameters(seed)
        self.model = model.to(self.device).eval()
        self.loss_weights = {
            "cls": float(p.get("cls_weight", 1.0)),
            "loc": float(p.get("loc_weight", 2.0)),
            "dir": float(p.get("dir_weight", 0.2)),
        }
        self.nms_iou = float(p.get("nms_iou", 0.5))
        self.score_thr = float(p.get("score_threshold", 0.1))
        self.assign_row_chunk = int(p.get("assign_row_chunk", 4096))
        # Windowed assigner (0 = the dense reference). The window must
        # cover gt_diag + anchor_diag; it never exceeds the feature map.
        self.assign_window = min(int(p.get("assign_window", 32)),
                                 min(self.fmap))

    def build_model(self, cfg: Config):
        """``PointPillarsFused`` (``fused``, the default) or the
        voxel-buffer ``PointPillars``. ``fast_encoder`` selects in the
        JAX package between its encoder kernel, which routes each cell's
        max through one bf16 value, and its exact XLA encoder; the port's
        kernel computes the exact canvas, so both values run it."""
        p = cfg.model.params
        self.fused = bool(p.get("fused", True))
        common = dict(
            num_classes=self.num_classes,
            grid_size=self.grid,
            voxel_size=tuple(cfg.voxel.voxel_size[:2]),
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
        if self.fused:
            return PointPillarsFused(
                pc_range=tuple(cfg.voxel.point_cloud_range), **common)
        return PointPillars(
            pc_range_min=tuple(cfg.voxel.point_cloud_range[:2]), **common)

    # -- data --------------------------------------------------------------

    def make_dataset(self, split: str):
        return KittiDetection(self.cfg, split)

    def augment_fn(self, split: str):
        if split != "train" or not self.cfg.data.augment.enabled:
            return None
        aug = self.cfg.data.augment
        sampler = None
        if aug.gt_sampling:
            sampler = GTSampler(self.make_dataset("train"))
        return lambda s, rng: augment_detection(s, rng, aug, sampler)

    # -- training ----------------------------------------------------------

    def assign(self, batch: Dict[str, torch.Tensor]):
        """Targets for a batch of padded gts (no gradient)."""
        args = (self.anchors, self.anchor_classes, self.pos_thr,
                self.neg_thr)
        gts = (batch["gt_boxes"], batch["gt_classes"], batch["gt_mask"])
        with torch.no_grad():
            if self.assign_window:
                return assign_targets_windowed_batched(
                    *args, self.class_sizes, self.class_z, *gts,
                    feature_map_size=self.fmap,
                    pc_range=tuple(self.cfg.voxel.point_cloud_range),
                    window=self.assign_window)
            frames = [assign_targets(*args, b, c, m,
                                     row_chunk=self.assign_row_chunk)
                      for b, c, m in zip(*gts)]
            return type(frames[0])(*(torch.stack(f) for f in zip(*frames)))

    def _voxelize_batch(self, points, point_mask):
        cfg = self.cfg
        return voxelize_batch(
            points, point_mask, pc_range=cfg.voxel.point_cloud_range,
            voxel_size=cfg.voxel.voxel_size, grid_size=self.grid,
            max_voxels=cfg.budget.max_voxels,
            max_points_per_voxel=cfg.budget.max_points_per_voxel)

    def _model_args(self, batch):
        """What the model's forward takes from a batch: the points and
        mask, or for the voxel-buffer model the voxelizer's table (no
        gradient flows into it)."""
        if self.fused:
            return batch["points"], batch["point_mask"]
        vox = self._voxelize_batch(batch["points"], batch["point_mask"])
        return vox.voxels, vox.coords, vox.num_points, vox.num_voxels

    def loss(self, batch, rng=None):
        preds = self.model(*self._model_args(batch))
        return self.loss_terms(preds, self.assign(batch))

    def loss_terms(self, preds, assign):
        """(total, aux) from the head's predictions and the targets;
        under a data mesh this rank's shares, over the global batch's
        positives."""
        pos = assign.positive                              # (B, A)
        num_pos_sum = pos.sum()
        num_pos = global_sum(num_pos_sum).float().clamp_min(1.0)  # whole batch

        # Classification: focal loss, one-vs-all; bg = all-zero targets,
        # ignored anchors (-1) masked out.
        cls_t = assign.cls_targets                         # (B, A)
        cls_p = preds["cls"]                               # (B, A, C)
        cls_ids = torch.arange(1, self.num_classes + 1, dtype=cls_t.dtype,
                               device=cls_t.device)
        onehot = (cls_t[..., None] == cls_ids).to(cls_p.dtype)
        focal = sigmoid_focal_loss(cls_p, onehot)
        valid = (cls_t >= 0)[..., None]
        cls_loss = torch.where(valid, focal, 0.0).sum() / num_pos

        # Localization: smooth-L1 on encoded residuals with sin-diff.
        pred_box, target_box = sin_difference(preds["box"],
                                              assign.reg_targets)
        loc = smooth_l1(pred_box, target_box)
        loc_loss = torch.where(pos[..., None], loc, 0.0).sum() / num_pos

        # Direction classifier on positives: the two-logit softmax CE is
        # softplus(l_other - l_target).
        d = preds["dir"][..., 1] - preds["dir"][..., 0]
        ce = F.softplus(torch.where(assign.dir_targets == 1, -d, d))
        dir_ce = torch.where(pos, ce, 0.0).sum() / num_pos

        w = self.loss_weights
        total = (w["cls"] * cls_loss + w["loc"] * loc_loss
                 + w["dir"] * dir_ce)
        aux = {
            "cls_loss": cls_loss,
            "loc_loss": loc_loss,
            "dir_loss": dir_ce,
            "num_pos": num_pos_sum / (pos.shape[0] * world_size()),
        }
        return total, aux

    # -- inference ---------------------------------------------------------

    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        preds = self.model(*self._model_args(batch))
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

    # -- evaluation --------------------------------------------------------

    def evaluate(self, max_batches: int = 0) -> Dict[str, float]:
        """Recall of the gt boxes at BEV IoU >= 0.5 and the mean count of
        kept boxes over the ``val`` split, and KITTI AP (simple and
        official) unless ``model.params.eval_ap`` is false. One pass over
        the split gives both: the frames and numbers of the JAX package's
        recall pass and AP pass."""
        dets, gts = collect_detections(
            self, split="val",
            max_frames=max_batches * self.cfg.train.batch_size)
        total_gt = hit_gt = num_det = 0
        for det, gt in zip(dets, gts):
            stats = match_frame(det["boxes"], det["labels"], gt["boxes"],
                                gt["classes"], iou_threshold=0.5)
            total_gt += stats["num_gt"]
            hit_gt += stats["num_hit"]
            num_det += stats["num_det"]
        metrics = {"recall@0.5": hit_gt / max(total_gt, 1),
                   "mean_detections": num_det / max(len(dets), 1)}
        if self.cfg.model.params.get("eval_ap", True):
            metrics.update(kitti_ap(dets, gts, self.num_classes))
        return metrics


@register_pipeline("second")
class SECONDPipeline(PointPillarsPipeline):
    """SECOND-style sparse-voxel detector: the same program as
    PointPillars with the pillar encoder replaced by voxelize + mean-VFE
    and the sparse 3D middle encoder. The anchor map sits on the 8x
    downsampled BEV grid."""

    OUTPUT_STRIDE = 8

    def _model_args(self, batch):
        cfg = self.cfg
        vox = voxelize_mean_batch(
            batch["points"], batch["point_mask"],
            pc_range=cfg.voxel.point_cloud_range,
            voxel_size=cfg.voxel.voxel_size, grid_size=self.grid,
            max_voxels=cfg.budget.max_voxels,
            max_points_per_voxel=cfg.budget.max_points_per_voxel)
        return vox.feats, vox.coords, vox.num_points, vox.num_voxels

    def build_model(self, cfg: Config) -> SECONDNet:
        p = cfg.model.params
        mv = cfg.budget.max_voxels
        return SECONDNet(
            num_classes=self.num_classes,
            grid_size=self.grid,
            num_anchors_per_cell=self.num_classes * 2,
            level_budgets=tuple(p.get(
                "level_budgets", [mv, mv // 2, mv // 4, mv // 8])),
            dense_from_level=int(p.get("dense_from_level", 2)),
            downsample=str(p.get("downsample", "dilate")),
            encoder_channels=tuple(p.get("encoder_channels",
                                         [16, 32, 64, 64])),
            bev_layers=tuple(p.get("bev_layers", [5, 5])),
            bev_filters=tuple(p.get("bev_filters", [128, 256])),
            bev_strides=tuple(p.get("bev_strides", [1, 2])),
            bev_up_strides=tuple(p.get("bev_up_strides", [1, 2])),
            bev_up_filters=tuple(p.get("bev_up_filters", [256, 256])),
            dtype=_DTYPES[p.get("dtype", "float32")],
        )
