"""Point-cloud classification on ModelNet40 (port of
``lisec_tpu/pipelines/classification.py``): PointNet (T-Nets, shared
MLPs, max-pool, FC head; no kernel) and PointNet++ SSG (the ``fps`` and
``gather_rows`` kernels under its set abstractions). Softmax
cross-entropy, plus ``reg_weight`` times the feature transform's
orthogonality loss.
"""

from __future__ import annotations

from typing import Dict

import torch

from lisec_tpu_torch.config import Config
from lisec_tpu_torch.data.augment import augment_cloud
from lisec_tpu_torch.data.modelnet40 import ModelNet40
from lisec_tpu_torch.models.pointnet import PointNetCls, orthogonality_loss
from lisec_tpu_torch.models.pointnet2 import PointNet2Cls
from lisec_tpu_torch.parallel.mesh import mean_share
from lisec_tpu_torch.pipelines.base import Pipeline
from lisec_tpu_torch.registry import register_model, register_pipeline
from lisec_tpu_torch.training.losses import cross_entropy
from lisec_tpu_torch.training.metrics import AccuracyMeter

register_model("pointnet_cls")(PointNetCls)
register_model("pointnet2_cls")(PointNet2Cls)


@register_pipeline("pointnet_cls")
class PointNetClsPipeline(Pipeline):
    def __init__(self, cfg: Config, device="cuda", seed: int = 0):
        super().__init__(cfg, device)
        model, self.reg_weight = self.build_model(cfg)
        # Random weights from the seed; load_weights_npz replaces them and
        # init_state(seed) draws them anew for training.
        model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()
        self.dropout_generator = torch.Generator(
            device=self.device).manual_seed(cfg.train.seed)

    def build_model(self, cfg: Config):
        """(the network, the orthogonality loss's weight)."""
        p = cfg.model.params
        return PointNetCls(
            num_classes=cfg.data.num_classes,
            use_input_tnet=bool(p.get("use_input_tnet", True)),
            use_feature_tnet=bool(p.get("use_feature_tnet", True)),
            dropout_rate=float(p.get("dropout_rate", 0.4)),
        ), float(p.get("reg_weight", 1e-3))

    def init_state(self, seed: int = 0) -> None:
        """As ``Pipeline.init_state``, and the dropout masks' generator
        seeded anew from ``seed``."""
        super().init_state(seed)
        self.dropout_generator.manual_seed(seed)

    def make_dataset(self, split: str):
        return ModelNet40(self.cfg, split)

    def augment_fn(self, split: str):
        if split != "train" or not self.cfg.data.augment.enabled:
            return None
        aug = self.cfg.data.augment
        return lambda s, rng: augment_cloud(s, rng, aug)

    def loss(self, batch):
        out = self.model(batch["points"], batch["point_mask"],
                         generator=self.dropout_generator)
        logits, labels = out["logits"], batch["label"]
        ce = cross_entropy(logits, labels)
        ft = out["feature_transform"]
        reg = (orthogonality_loss(ft) if ft is not None
               else logits.new_zeros(()))
        acc = mean_share((logits.argmax(-1) == labels).float())
        return ce + self.reg_weight * reg, {"ce": ce, "reg": reg,
                                            "acc": acc}

    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        logits = self.model(batch["points"], batch["point_mask"])["logits"]
        return {"logits": logits,
                "labels": logits.argmax(-1).to(torch.int32)}

    def evaluate(self, max_batches: int = 0) -> Dict[str, float]:
        """Accuracy and class-mean accuracy over the ``test`` split."""
        meter = AccuracyMeter(self.cfg.data.num_classes)
        for batch, out in self.eval_outputs("test", max_batches):
            meter.update(out["labels"], batch["label"])
        return {"accuracy": meter.overall(),
                "class_mean_accuracy": meter.class_mean()}


@register_pipeline("pointnet2_cls")
class PointNet2ClsPipeline(PointNetClsPipeline):
    """PointNet++ SSG classification: the same pipeline with the
    hierarchical set-abstraction network and no regulariser."""

    def build_model(self, cfg: Config):
        return PointNet2Cls(
            num_classes=cfg.data.num_classes,
            width=int(cfg.model.params.get("width", 1))), 0.0
