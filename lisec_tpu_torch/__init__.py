"""lisec_tpu_torch: the PyTorch/CUDA port of lisec-tpu for NVIDIA Hopper.

It sits beside the JAX package ``lisec_tpu``, which stays the reference,
and imports nothing of it: what it needs of its host-side code is
copied. Plain tensor code is PyTorch; every TPU kernel on a ported path
is a CUDA kernel written for sm_90a (``csrc/``), built at its first
launch, beside a plain PyTorch version of the same function that the
wrappers take for CPU tensors.

Ported so far: PointPillars inference (``configs/pointpillars_kitti.yaml``)
with the fused pillar-encoder kernel. Public API::

    cfg      = lisec_tpu_torch.load_config("configs/pointpillars_kitti.yaml")
    pipeline = lisec_tpu_torch.build_model(cfg)          # device="cuda"
    lisec_tpu_torch.load_weights_npz(pipeline.model, "weights/....npz")
    batch    = lisec_tpu_torch.preprocess(lisec_tpu_torch.load_cloud(p), cfg)
    out      = lisec_tpu_torch.infer(pipeline, {k: v[None] for k, v in batch.items()})
"""

from lisec_tpu_torch.api import (
    build_model,
    infer,
    load_cloud,
    load_config,
    preprocess,
)
from lisec_tpu_torch.config import Config
from lisec_tpu_torch.weights import convert_flax_arrays, load_weights_npz

__all__ = [
    "Config",
    "build_model",
    "convert_flax_arrays",
    "infer",
    "load_cloud",
    "load_config",
    "load_weights_npz",
    "preprocess",
]
