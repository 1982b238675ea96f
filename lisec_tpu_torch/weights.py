"""Carry the JAX package's weights into the port.

The JAX package dumps ``params`` and ``batch_stats`` as flat npz keys
(``lisec_tpu/bench_lib.py::save_weights_npz``), e.g.
``params/BEVBackbone_0/ConvBNRelu_11/ConvTranspose_0/kernel`` or
``batch_stats/FusedPillarEncoder_0/mean``. ``convert_flax_arrays`` maps
every key onto the port's ``state_dict`` names and layouts:

* conv kernels (kh, kw, in, out) -> (out, in, kh, kw): ``permute(3, 2, 0, 1)``;
* transposed-conv kernels (kh, kw, in, out) -> (in, out, kh, kw), flipped
  in space: ``permute(2, 3, 0, 1).flip(2, 3)`` (flax's ``ConvTranspose``
  does not flip the kernel, ``conv_transpose2d`` does);
* SECOND's dense 3D conv kernels (kd, kh, kw, in, out) ->
  (out, in, kd, kh, kw): ``permute(4, 3, 0, 1, 2)``;
* Dense kernels (in, out) of PointNet++ -> ``nn.Linear`` weights
  (out, in): transposed;
* everything else (encoder kernel (9, C), sparse conv kernels
  (K, Cin, Cout), BN scale/bias/mean/var, biases) as it is.

PointNet++'s flax names map by module: ``SetAbstraction_i/SharedMLP_j``
-> ``sa.i.mlps.j``, ``GlobalSetAbstraction_0/SharedMLP_0`` ->
``global_sa.mlp``, the top-level ``SharedMLP_0`` (FP3) -> ``fp3``,
``FeaturePropagation_i/SharedMLP_0`` -> ``fp.i.mlp``, inside each
``Dense_k`` -> ``dense.k`` and ``BatchNorm_k`` -> ``bn.k``; the head's
``Dense_0``, ``BatchNorm_0`` and ``Dense_1`` -> ``head_dense``,
``head_bn``, ``head_out``.

``to_flax_arrays`` is the way back, for comparing gradients, updated
parameters and running statistics with the JAX package name by name.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

_HEAD = {"Conv_0": "cls", "Conv_1": "box", "Conv_2": "dir"}
# PointNet++: flax module path of a shared MLP -> the port's module.
_MLP_OWNERS = (
    (re.compile(r"SetAbstraction_(\d+)/SharedMLP_(\d+)$"),
     lambda m: f"sa.{m[1]}.mlps.{m[2]}"),
    (re.compile(r"GlobalSetAbstraction_0/SharedMLP_0$"),
     lambda m: "global_sa.mlp"),
    (re.compile(r"SharedMLP_0$"), lambda m: "fp3"),
    (re.compile(r"FeaturePropagation_(\d+)/SharedMLP_0$"),
     lambda m: f"fp.{m[1]}.mlp"),
)
_POINTNET2_HEAD = {"Dense_0": "head_dense", "BatchNorm_0": "head_bn",
                   "Dense_1": "head_out"}


def _pointnet2_name(m: "re.Match") -> str:
    owner, layer = m["owner"], m["layer"]
    leaf = "weight" if m["leaf"] == "kernel" else m["leaf"]
    if owner is None:
        return f"{_POINTNET2_HEAD[layer]}.{leaf}"
    for pattern, name in _MLP_OWNERS:
        o = pattern.match(owner)
        if o:
            kind, k = layer.split("_")
            return (f"{name(o)}.{'dense' if kind == 'Dense' else 'bn'}."
                    f"{k}.{leaf}")
    raise KeyError(owner)


_PATTERNS = (
    (re.compile(r"(params|batch_stats)/FusedPillarEncoder_0/"
                r"(kernel|scale|bias|mean|var)$"),
     lambda m: f"encoder.{m[2]}"),
    (re.compile(r"params/SparseMiddleEncoder_0/SparseConv3D_(\d+)/kernel$"),
     lambda m: f"encoder.sparse.{m[1]}.weight"),
    (re.compile(r"(params|batch_stats)/SparseMiddleEncoder_0/"
                r"SparseConv3D_(\d+)/BatchNorm_0/(scale|bias|mean|var)$"),
     lambda m: f"encoder.sparse.{m[2]}.{m[3]}"),
    (re.compile(r"params/SparseMiddleEncoder_0/Conv_(\d+)/kernel$"),
     lambda m: f"encoder.dense.{m[1]}.weight"),
    (re.compile(r"(params|batch_stats)/SparseMiddleEncoder_0/"
                r"MaskedBatchNorm_(\d+)/(scale|bias|mean|var)$"),
     lambda m: f"encoder.dense.{m[2]}.{m[3]}"),
    (re.compile(r"params/BEVBackbone_0/ConvBNRelu_(\d+)/"
                r"(Conv|ConvTranspose)_0/kernel$"),
     lambda m: f"backbone.layers.{m[1]}.weight"),
    (re.compile(r"(params|batch_stats)/BEVBackbone_0/ConvBNRelu_(\d+)/"
                r"BatchNorm_0/(scale|bias|mean|var)$"),
     lambda m: f"backbone.layers.{m[2]}.{m[3]}"),
    (re.compile(r"params/AnchorHead_0/(Conv_[012])/(kernel|bias)$"),
     lambda m: f"head.{_HEAD[m[1]]}."
               f"{'weight' if m[2] == 'kernel' else 'bias'}"),
    (re.compile(r"(params|batch_stats)/(?:(?P<owner>(?:SetAbstraction_\d+/"
                r"|GlobalSetAbstraction_0/|FeaturePropagation_\d+/)?"
                r"SharedMLP_\d+)/)?(?P<layer>(?:Dense|BatchNorm)_\d+)/"
                r"(?P<leaf>kernel|bias|scale|mean|var)$"),
     _pointnet2_name),
)


def _convert_value(key: str, arr: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, np.float32))
    if re.search(r"Dense_\d+/kernel$", key):
        return t.T.contiguous()
    if key.endswith("ConvTranspose_0/kernel"):
        return t.permute(2, 3, 0, 1).flip(2, 3).contiguous()
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1).contiguous()
    if t.dim() == 5:
        return t.permute(4, 3, 0, 1, 2).contiguous()
    return t


def convert_flax_arrays(flat: Dict[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
    """Flat flax arrays -> the ``state_dict`` of the port's
    PointPillarsFused, SECONDNet or PointNet2PartSeg.

    Raises KeyError on a key it cannot place."""
    out = {}
    for key, arr in flat.items():
        for pattern, name in _PATTERNS:
            m = pattern.match(key)
            if m:
                out[name(m)] = _convert_value(key, arr)
                break
        else:
            raise KeyError(f"no place in the port's model for {key!r}")
    return out


def load_weights_npz(model: nn.Module, path: str) -> nn.Module:
    """Load a ``save_weights_npz`` snapshot into ``model`` (in place).

    Strict: a parameter the snapshot does not fill, a key the model does
    not use or a shape that differs raises."""
    with np.load(path) as data:
        state = convert_flax_arrays({k: data[k] for k in data.files})
    model.load_state_dict(state, strict=True)
    return model


_BUFFERS = ("mean", "var")


_POINTNET2_PARTS = {"sa", "global_sa", "fp3", "fp", *_POINTNET2_HEAD.values()}


def _pointnet2_flax_key(name: str) -> str:
    """PointNet++ ``state_dict`` name -> flat flax key."""
    part, _, rest = name.partition(".")
    if part in _POINTNET2_HEAD.values():
        layer = {v: k for k, v in _POINTNET2_HEAD.items()}[part]
        owner, leaf = "", rest
    else:
        if part == "sa":                   # sa.<i>.mlps.<j>.<rest>
            i, _, j, rest = rest.split(".", 3)
            owner = f"SetAbstraction_{i}/SharedMLP_{j}/"
        elif part == "global_sa":          # global_sa.mlp.<rest>
            owner, rest = "GlobalSetAbstraction_0/SharedMLP_0/", rest[4:]
        elif part == "fp3":
            owner = "SharedMLP_0/"
        else:                              # fp.<i>.mlp.<rest>
            i, _, rest = rest.split(".", 2)
            owner = f"FeaturePropagation_{i}/SharedMLP_0/"
        kind, k, leaf = rest.split(".")
        layer = f"{'Dense' if kind == 'dense' else 'BatchNorm'}_{k}"
    col = "batch_stats" if leaf in _BUFFERS else "params"
    return f"{col}/{owner}{layer}/{'kernel' if leaf == 'weight' else leaf}"


def _flax_key(name: str) -> str:
    """``state_dict`` name -> flat flax key."""
    if name.partition(".")[0] in _POINTNET2_PARTS:
        return _pointnet2_flax_key(name)
    col = "batch_stats" if name.rsplit(".", 1)[1] in _BUFFERS else "params"
    part, _, rest = name.partition(".")
    if part == "encoder" and "." not in rest:
        return f"{col}/FusedPillarEncoder_0/{rest}"
    if part == "encoder":                          # encoder.<list>.<i>.<leaf>
        kind, i, leaf = rest.split(".")
        conv, bn = (("SparseConv3D_{}/kernel", "SparseConv3D_{}/BatchNorm_0/")
                    if kind == "sparse" else ("Conv_{}/kernel",
                                              "MaskedBatchNorm_{}/"))
        return f"{col}/SparseMiddleEncoder_0/" + (
            conv.format(i) if leaf == "weight" else bn.format(i) + leaf)
    if part == "head":
        conv, leaf = rest.split(".")
        flax_conv = {v: k for k, v in _HEAD.items()}[conv]
        return (f"params/AnchorHead_0/{flax_conv}/"
                f"{'kernel' if leaf == 'weight' else 'bias'}")
    _, i, leaf = rest.split(".")                   # backbone.layers.<i>.<leaf>
    return f"{col}/BEVBackbone_0/ConvBNRelu_{i}/" + (
        "{conv}/kernel" if leaf == "weight" else f"BatchNorm_0/{leaf}")


def to_flax_arrays(model: nn.Module,
                   tensors: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`convert_flax_arrays`: the model's
    ``state_dict`` as flat ``params/...`` and ``batch_stats/...`` numpy
    arrays in flax layouts. ``tensors`` (same names and layouts as the
    ``state_dict``, e.g. the parameters' gradients) is converted instead
    when given."""
    transposed = {f"backbone.layers.{i}.weight"
                  for i, layer in enumerate(model.backbone.layers)
                  if layer.transpose} if hasattr(model, "backbone") else ()
    out = {}
    for name, t in (model.state_dict() if tensors is None
                    else tensors).items():
        t = t.detach().cpu().float()
        key = _flax_key(name)
        if t.dim() == 2 and "/Dense_" in key:      # nn.Linear (out, in)
            t = t.T
        elif name in transposed:                   # undo flip and permute
            t = t.flip(2, 3).permute(2, 3, 0, 1)
            key = key.format(conv="ConvTranspose_0")
        elif t.dim() == 4:
            t = t.permute(2, 3, 1, 0)
            key = key.format(conv="Conv_0")
        elif t.dim() == 5:
            t = t.permute(2, 3, 4, 1, 0)
        out[key] = t.contiguous().numpy()
    return out
