"""PointNet++ part segmentation on ShapeNetPart (port of
``lisec_tpu/pipelines/partseg.py``): farthest-point sampling -> ball
query -> grouping -> three-NN interpolation, a per-point head with the
category one-hot, softmax cross-entropy over the valid points.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from lisec_tpu_torch.config import Config
from lisec_tpu_torch.data.augment import augment_cloud
from lisec_tpu_torch.data.shapenetpart import ShapeNetPart
from lisec_tpu_torch.models.pointnet2 import PointNet2PartSeg
from lisec_tpu_torch.pipelines.base import Pipeline
from lisec_tpu_torch.registry import register_model, register_pipeline
from lisec_tpu_torch.training.losses import cross_entropy

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
        model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()
        self.dropout_generator = torch.Generator(
            device=self.device).manual_seed(cfg.train.seed)

    def init_state(self, seed: int = 0) -> None:
        """As ``Pipeline.init_state``, and the dropout masks' generator
        seeded anew from ``seed``."""
        super().init_state(seed)
        self.dropout_generator.manual_seed(seed)

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

    def loss(self, batch):
        logits = self.model(*self._model_args(batch),
                            generator=self.dropout_generator)
        labels = batch["point_labels"]
        ce = cross_entropy(logits, labels, mask=batch["point_mask"])
        valid = batch["point_mask"].bool() & (labels >= 0)
        acc = ((logits.argmax(-1) == labels) & valid).sum() \
            / valid.sum().clamp_min(1)
        return ce, {"acc": acc}

    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        logits = self.model(*self._model_args(batch))
        return {"logits": logits,
                "labels": logits.argmax(-1).to(torch.int32)}

    def evaluate(self, *args, **kwargs):
        raise NotImplementedError(
            "part-segmentation evaluation (class and instance mIoU, "
            "training/metrics.py) is not ported to lisec_tpu_torch yet")
