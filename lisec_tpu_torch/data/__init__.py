"""Data layer (port of ``lisec_tpu/data``): loaders for the four dataset
families, per-cloud augmentation and fixed-shape collation, all host-side
numpy; every batch handed to the card is padded to the config budgets."""

from lisec_tpu_torch.data.collate import make_batches, pad_points, pad_to_budget
from lisec_tpu_torch.data.modelnet40 import ModelNet40
from lisec_tpu_torch.data.shapenetpart import ShapeNetPart
from lisec_tpu_torch.data.kitti import Calibration, KittiDetection
from lisec_tpu_torch.data.semantickitti import SemanticKitti
from lisec_tpu_torch.data.augment import (
    GTSampler, augment_cloud, augment_detection)

__all__ = [
    "pad_points", "pad_to_budget", "make_batches",
    "ModelNet40", "ShapeNetPart", "KittiDetection", "Calibration",
    "SemanticKitti", "augment_cloud", "augment_detection", "GTSampler",
]
