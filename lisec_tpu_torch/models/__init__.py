"""Models (port of ``lisec_tpu/models``). Importing this package
registers every model and pipeline in the registry."""

from lisec_tpu_torch.models.pointnet import (
    PointNetCls, TNet, orthogonality_loss)
from lisec_tpu_torch.models.common import ConvBNRelu, MLPHead, SharedMLP
import lisec_tpu_torch.pipelines  # noqa: F401,E402 (registration)

__all__ = [
    "PointNetCls", "TNet", "orthogonality_loss",
    "SharedMLP", "MLPHead", "ConvBNRelu",
]
