"""PointNet++ part segmentation on ShapeNetPart (port of
``lisec_tpu/pipelines/partseg.py``): farthest-point sampling -> ball
query -> grouping -> three-NN interpolation, a per-point head with the
category one-hot, softmax cross-entropy over the valid points; class and
instance mIoU for evaluation.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from lisec_tpu_torch.config import Config
from lisec_tpu_torch.data.augment import augment_cloud
from lisec_tpu_torch.data.shapenetpart import ShapeNetPart
from lisec_tpu_torch.models.pointnet2 import PointNet2PartSeg
from lisec_tpu_torch.parallel.mesh import global_sum
from lisec_tpu_torch.pipelines.base import Pipeline
from lisec_tpu_torch.registry import register_model, register_pipeline
from lisec_tpu_torch.training.losses import cross_entropy
from lisec_tpu_torch.training.metrics import IoUMeter, instance_miou

register_model("pointnet2_partseg")(PointNet2PartSeg)


@register_pipeline("pointnet2_partseg")
class PointNet2PartSegPipeline(Pipeline):
    def __init__(self, cfg: Config, device="cuda", seed: int = 0):
        super().__init__(cfg, device)
        p = cfg.model.params
        self.num_categories = int(p.get("num_categories", 16))
        self.parts_per_cat = int(p.get("parts_per_cat", 3))
        self.num_parts = int(
            p.get("num_parts", self.num_categories * self.parts_per_cat))
        model = PointNet2PartSeg(
            num_parts=self.num_parts, num_categories=self.num_categories,
            width=int(p.get("width", 1)), msg=bool(p.get("msg", False)))
        # Random weights from the seed; load_weights_npz replaces them and
        # init_state(seed) draws them anew for training.
        model.reset_parameters(seed)
        self.model = model.to(self.device).eval()

    def make_dataset(self, split: str):
        return ShapeNetPart(self.cfg, split)

    def augment_fn(self, split: str):
        if split != "train" or not self.cfg.data.augment.enabled:
            return None
        aug = self.cfg.data.augment
        return lambda s, rng: augment_cloud(s, rng, aug)

    def _model_args(self, batch):
        """What the model's forward takes from a batch."""
        onehot = F.one_hot(batch["category"].long(),
                           self.num_categories).float()
        return batch["points"], batch["point_mask"], onehot

    def loss(self, batch, rng=None):
        logits = self.model(*self._model_args(batch),
                            rng=self.step_key() if rng is None else rng)
        labels = batch["point_labels"]
        ce = cross_entropy(logits, labels, mask=batch["point_mask"])
        valid = batch["point_mask"].bool() & (labels >= 0)
        acc = ((logits.argmax(-1) == labels) & valid).sum() \
            / global_sum(valid.sum()).clamp_min(1)
        return ce, {"acc": acc}

    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        logits = self.model(*self._model_args(batch))
        return {"logits": logits,
                "labels": logits.argmax(-1).to(torch.int32)}

    def evaluate(self, max_batches: int = 0) -> Dict[str, float]:
        """Class mIoU and instance mIoU (each shape over its category's
        parts) of the valid points over the ``test`` split."""
        meter = IoUMeter(self.num_parts)
        preds, labels, parts = [], [], []
        for batch, out in self.eval_outputs("test", max_batches):
            for i, pred in enumerate(out["labels"]):
                m = batch["point_mask"][i]
                meter.update(pred[m], batch["point_labels"][i][m])
                preds.append(pred[m])
                labels.append(batch["point_labels"][i][m])
                cat = int(batch["category"][i])
                parts.append(range(cat * self.parts_per_cat,
                                   (cat + 1) * self.parts_per_cat))
        return {"class_miou": meter.miou(),
                "instance_miou": instance_miou(preds, labels, parts)}
