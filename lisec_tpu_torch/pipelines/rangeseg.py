"""SemanticKITTI range-image segmentation (port of
``lisec_tpu/pipelines/rangeseg.py``): range projection -> encoder-decoder
-> per-pixel logits -> range-window kNN refinement -> per-point labels,
all on the pipeline's device. Training takes softmax cross-entropy plus
``lovasz_weight`` times Lovász-softmax over the occupied, labelled
pixels, each pixel labelled by its projection winner; evaluation takes
the point mIoU.
"""

from __future__ import annotations

from typing import Dict

import torch

from lisec_tpu_torch.config import Config
from lisec_tpu_torch.data.semantickitti import SemanticKitti
from lisec_tpu_torch.models.rangeseg import RangeSegNet
from lisec_tpu_torch.ops.knn_refine import knn_refine_batch
from lisec_tpu_torch.ops.range_proj import RangeImage, range_project_batch
from lisec_tpu_torch.parallel.mesh import global_sum
from lisec_tpu_torch.pipelines.base import Pipeline
from lisec_tpu_torch.registry import register_model, register_pipeline
from lisec_tpu_torch.training.losses import cross_entropy, lovasz_softmax
from lisec_tpu_torch.training.metrics import IoUMeter

register_model("rangeseg")(RangeSegNet)


@register_pipeline("rangeseg")
class RangeSegPipeline(Pipeline):
    def __init__(self, cfg: Config, device="cuda", seed: int = 0):
        super().__init__(cfg, device)
        p = cfg.model.params
        self.num_classes = cfg.data.num_classes or 20
        self.height = int(p.get("height", 64))
        self.width = int(p.get("width", 2048))
        self.fov_up = float(p.get("fov_up_deg", 3.0))
        self.fov_down = float(p.get("fov_down_deg", -25.0))
        self.knn_k = int(p.get("knn_k", 5))
        self.knn_window = int(p.get("knn_window", 5))
        self.lovasz_weight = float(p.get("lovasz_weight", 1.0))
        model = RangeSegNet(
            num_classes=self.num_classes,
            widths=tuple(p.get("widths", [32, 64, 128, 256])),
            dtype=getattr(torch, p.get("dtype", "float32")))
        # Random weights from the seed; load_weights_npz replaces them and
        # init_state(seed) draws them anew for training.
        model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()

    def make_dataset(self, split: str):
        return SemanticKitti(self.cfg, split)

    def _project(self, points, point_mask) -> RangeImage:
        return range_project_batch(
            points, point_mask, height=self.height, width=self.width,
            fov_up_deg=self.fov_up, fov_down_deg=self.fov_down)

    @staticmethod
    def _label_image(proj: RangeImage, point_labels: torch.Tensor
                     ) -> torch.Tensor:
        """Per-pixel training labels from per-point ones by the
        projection's winner index (-1 where no point)."""
        n = point_labels.shape[1]
        padded = torch.cat([point_labels,
                            point_labels.new_full((len(point_labels), 1),
                                                  -1)], 1)
        win = proj.winner_idx.clamp(max=n).long().flatten(1)
        return padded.gather(1, win).view(proj.winner_idx.shape)

    def loss(self, batch):
        proj = self._project(batch["points"], batch["point_mask"])
        logits = self.model(proj.image)
        labels = self._label_image(proj, batch["point_labels"])
        pix_mask = proj.image_mask & (labels >= 0)
        ce = cross_entropy(logits, labels, mask=pix_mask)
        lov = lovasz_softmax(torch.softmax(logits, -1), labels,
                             num_classes=self.num_classes, mask=pix_mask)
        acc = ((logits.argmax(-1) == labels) & pix_mask).sum() \
            / global_sum(pix_mask.sum()).clamp_min(1)
        return ce + self.lovasz_weight * lov, {"ce": ce, "lovasz": lov,
                                               "acc": acc}

    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        proj = self._project(batch["points"], batch["point_mask"])
        pixel_labels = self.model(proj.image).argmax(-1).to(torch.int32)
        labels = knn_refine_batch(
            proj.point_range, proj.pixel_pix, proj.image[..., 0],
            pixel_labels, proj.image_mask, window=self.knn_window,
            k=self.knn_k, num_classes=self.num_classes)
        return {"labels": labels, "pixel_labels": pixel_labels}

    def evaluate(self, max_batches: int = 0) -> Dict[str, float]:
        """Point mIoU over the ``val`` split of the valid, labelled
        points: ``miou`` without class 0 (unlabelled), ``miou_all`` with
        it."""
        meter = IoUMeter(self.num_classes)
        for batch, out in self.eval_outputs("val", max_batches):
            for i, pred in enumerate(out["labels"]):
                labels = batch["point_labels"][i]
                m = batch["point_mask"][i] & (labels >= 0)
                meter.update(pred[m], labels[m])
        return {"miou": meter.miou(skip_class_0=True),
                "miou_all": meter.miou()}
