"""lisec_tpu_torch: the PyTorch/CUDA port of lisec-tpu for NVIDIA Hopper.

It sits beside the JAX package ``lisec_tpu``, which stays the reference,
and imports nothing of it: what it needs of its host-side code is
copied. Plain tensor code is PyTorch; every TPU kernel on a ported path
is a CUDA kernel written for sm_90a (``csrc/``), built at its first
launch, beside a plain PyTorch version of the same function that the
wrappers take for CPU tensors.

Ported so far: PointPillars inference (``configs/pointpillars_kitti.yaml``)
with the fused pillar-encoder kernel, PointPillars training
(``configs/pointpillars_fixture_hard_conv.yaml``) with the segment paint
and unpaint kernels, SECOND inference and training
(``configs/second_kitti.yaml``, ``configs/second_fixture_conv.yaml``) with
the spread-accumulate kernel under its sparse convs, and PointNet++ part
segmentation, inference and training
(``configs/pointnet2_partseg_fixture_conv.yaml``), with the
farthest-point-sampling kernel and the row gather and ordered row
scatter kernels under its grouping and interpolation. Every TPU kernel
of the JAX package now has its CUDA counterpart. Checkpoints,
data-parallel training, the detection augmentation and evaluation are
not ported yet and raise ``NotImplementedError`` when a config asks for
them. Public API::

    cfg      = lisec_tpu_torch.load_config("configs/pointpillars_kitti.yaml")
    pipeline = lisec_tpu_torch.build_model(cfg)          # device="cuda"
    lisec_tpu_torch.load_weights_npz(pipeline.model, "weights/....npz")
    batch    = lisec_tpu_torch.preprocess(lisec_tpu_torch.load_cloud(p), cfg)
    out      = lisec_tpu_torch.infer(pipeline, {k: v[None] for k, v in batch.items()})

    cfg = lisec_tpu_torch.apply_overrides(cfg, ["train.num_steps=100"])
    pipeline, history = lisec_tpu_torch.train(cfg)       # device="cuda"

Every entry point takes ``device`` (default ``"cuda"``; ``"cpu"`` runs the
kernels' plain PyTorch versions, as the tests do).
"""

from lisec_tpu_torch.api import (
    build_model,
    infer,
    load_cloud,
    load_config,
    preprocess,
    train,
)
from lisec_tpu_torch.config import Config, apply_overrides
from lisec_tpu_torch.weights import (
    convert_flax_arrays, load_weights_npz, to_flax_arrays)

__all__ = [
    "Config",
    "apply_overrides",
    "build_model",
    "convert_flax_arrays",
    "infer",
    "load_cloud",
    "load_config",
    "load_weights_npz",
    "preprocess",
    "to_flax_arrays",
    "train",
]
