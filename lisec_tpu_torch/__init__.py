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
the spread-accumulate kernel under its sparse convs, PointNet++ part
segmentation, inference and training
(``configs/pointnet2_partseg_fixture_conv.yaml``), with the
farthest-point-sampling kernel and the row gather and ordered row
scatter kernels under its grouping and interpolation, range-image
segmentation on SemanticKITTI, inference and training
(``configs/rangeseg_semantickitti.yaml``,
``configs/rangeseg_fixture_conv.yaml``), whose range projection runs the
segment paint kernel and whose kNN refinement runs the spread-accumulate
kernel, and ModelNet40 classification, inference and training, with
PointNet (``configs/pointnet_cls_fixture_conv.yaml``, no kernel) and
PointNet++ (``configs/pointnet2_modelnet40.yaml``, the sampling and
gather kernels). Every workload has its ``evaluate`` (accuracy, mIoU,
recall and KITTI AP). Every TPU kernel of the JAX package has its CUDA
counterpart. Training saves checkpoints to ``train.ckpt_dir`` and
resumes from them (``train.resume``), with the detectors' augmentation
(GT sampling, per-box noise, global transforms), the TensorBoard mirror
and NaN checks; ``python -m lisec_tpu_torch.cli`` has ``train``,
``eval`` and ``infer``, and ``python3 portbench/run.py --workload
<cell>`` measures the port end to end on the card. Serving also takes
the int16 wire (``data/wire.py``, ``Pipeline.infer_packed``), and
``model.params.fused: false`` builds the voxel-buffer PointPillars. Data parallelism (``parallel/``): ``train``
with ``train.num_devices`` W > 1 runs one process a rank (``torchrun``;
NCCL on the card, gloo on the CPU) and computes what one device computes
on the global batch; ``Pipeline.infer_dp`` predicts a global batch's
rows on their ranks; ``train.multihost`` feeds each process its own
shard of the examples. The surface is complete: every public name of
the JAX package has its counterpart at the same module path (the host
helpers of ``native/``, the fixture writers, ``ops.gather_points``,
``ops.sparse_conv.build_subm_scatter_rulebook``, the package exports,
``__version__``), apart from the few TPU-only names that
``tests/test_torch_surface.py`` lists with their reasons. Public API::

    cfg      = lisec_tpu_torch.load_config("configs/pointpillars_kitti.yaml")
    pipeline = lisec_tpu_torch.build_model(cfg)          # device="cuda"
    lisec_tpu_torch.load_weights_npz(pipeline.model, "weights/....npz")
    batch    = lisec_tpu_torch.preprocess(lisec_tpu_torch.load_cloud(p), cfg)
    out      = lisec_tpu_torch.infer(pipeline, {k: v[None] for k, v in batch.items()})

    cfg = lisec_tpu_torch.apply_overrides(cfg, ["train.num_steps=100"])
    pipeline, history = lisec_tpu_torch.train(cfg)       # device="cuda"
    metrics = lisec_tpu_torch.evaluate(cfg, pipeline)
    metrics = lisec_tpu_torch.evaluate(cfg)   # the latest checkpoint's

Every entry point takes ``device`` (default ``"cuda"``; ``"cpu"`` runs the
kernels' plain PyTorch versions, as the tests do).
"""

from lisec_tpu_torch.version import __version__
from lisec_tpu_torch.config import (
    Config, apply_overrides, config_from_dict, config_to_dict)
from lisec_tpu_torch.api import (
    build_model,
    evaluate,
    infer,
    load_cloud,
    load_config,
    preprocess,
    train,
)
from lisec_tpu_torch.weights import (
    convert_flax_arrays, load_weights_npz, to_flax_arrays)

__all__ = [
    "__version__",
    "Config",
    "apply_overrides",
    "build_model",
    "config_from_dict",
    "config_to_dict",
    "convert_flax_arrays",
    "evaluate",
    "infer",
    "load_cloud",
    "load_config",
    "load_weights_npz",
    "preprocess",
    "to_flax_arrays",
    "train",
]
