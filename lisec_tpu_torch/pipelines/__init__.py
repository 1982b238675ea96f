"""Workload pipelines (port of ``lisec_tpu/pipelines``): model,
preprocessing, losses and inference of each workload. Importing this
package populates the model and pipeline registries."""

from lisec_tpu_torch.pipelines.base import Pipeline
from lisec_tpu_torch.pipelines import classification  # noqa: F401
from lisec_tpu_torch.pipelines import partseg  # noqa: F401
from lisec_tpu_torch.pipelines import detection  # noqa: F401
from lisec_tpu_torch.pipelines import rangeseg  # noqa: F401

__all__ = ["Pipeline"]
