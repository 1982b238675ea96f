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

PointNet2Cls maps its set abstractions the same way and its top-level
``Dense_k`` and ``BatchNorm_k`` (the head) -> ``head.dense.k`` and
``head.bn.k``. PointNetCls maps by module path: ``TNet_i`` -> ``tnets.i``
(the T-Nets present, in order), ``SharedMLP_j`` -> ``mlps.j``,
``MLPHead_0`` -> ``head``, inside each ``Dense_k`` -> ``dense.k`` and
``BatchNorm_k`` -> ``bn.k``, and a T-Net's own ``Dense_0`` -> ``out``.

RangeSegNet's map by position (``lisec_tpu_torch/models/rangeseg.py``):
``ConvBNRelu_0`` -> ``stem``; the top-level ``Conv_i`` and
``BatchNorm_i`` below the level count L -> ``down.i``;
``ConvTranspose_i`` and ``BatchNorm_{L + i}`` -> ``up.i``; ``Conv_L``
(the head, with its bias) -> ``head``; ``_ResBlock_j/ConvBNRelu_c`` ->
``blocks.j.conv.c`` and ``_ResBlock_j/Conv_0`` -> ``blocks.j.proj``. L is
the number of top-level ``ConvTranspose_i``, and every one of them is a
transposed kernel.

The voxel-buffer PointPillars (``FLAX_KEYS`` ``"pointpillars"``) maps
``PillarFeatureNet_0/Dense_0`` -> ``pfn.dense`` and
``PillarFeatureNet_0/BatchNorm_0`` -> ``pfn.bn``, its backbone and head
as the fused model's.

The classifiers name their map: their classes' ``FLAX_KEYS``
(``"pointnet_cls"``, ``"pointnet2_cls"``) go to ``convert_flax_arrays``
as ``keys``; RangeSegNet's is ``"rangeseg"``. Without ``keys`` the
detectors', part segmentation's and range segmentation's maps are told
apart by range segmentation's top-level transposed convs.

``to_flax_arrays`` is the way back, for comparing gradients, updated
parameters and running statistics with the JAX package name by name.
"""

from __future__ import annotations

import hashlib
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


_BUFFERS = ("mean", "var")
_POINTNET_OWNERS = {"TNet": "tnets", "SharedMLP": "mlps"}
# PointNet2Cls's head: its top-level Dense and BatchNorm layers.
_CLS_HEAD = re.compile(r"(?:params|batch_stats)/(?P<kind>Dense|BatchNorm)_"
                       r"(?P<k>\d+)/(?P<leaf>kernel|bias|scale|mean|var)$")


def _pointnet_cls_name(key: str) -> str:
    """Flat flax key of PointNetCls -> the port's ``state_dict`` name."""
    _, *owners, layer, leaf = key.split("/")
    kind, _, k = layer.rpartition("_")
    names = []
    for owner in owners:
        o_kind, _, i = owner.rpartition("_")
        if owner == "MLPHead_0":
            names.append("head")
        elif o_kind in _POINTNET_OWNERS:
            names += [_POINTNET_OWNERS[o_kind], i]
        else:
            names = []
            break
    if not names or kind not in ("Dense", "BatchNorm"):
        raise KeyError(f"no place in the port's model for {key!r}")
    leaf = "weight" if leaf == "kernel" else leaf
    if owners[-1].startswith("TNet_"):            # the T-Net's last Dense
        return ".".join(names + ["out", leaf])
    return ".".join(names + ["dense" if kind == "Dense" else "bn", k, leaf])


def _pointnet_cls_flax_key(name: str) -> str:
    """PointNetCls ``state_dict`` name -> flat flax key."""
    parts = name.split(".")
    leaf = parts.pop()
    path = []
    while parts[0] in _POINTNET_OWNERS.values():
        kind = {v: k for k, v in _POINTNET_OWNERS.items()}[parts[0]]
        path.append(f"{kind}_{parts[1]}")
        parts = parts[2:]
    if parts[0] == "head":
        path.append("MLPHead_0")
        parts = parts[1:]
    layer = ("Dense_0" if parts == ["out"] else
             f"{'Dense' if parts[0] == 'dense' else 'BatchNorm'}_{parts[1]}")
    col = "batch_stats" if leaf in _BUFFERS else "params"
    return (f"{col}/{'/'.join(path)}/{layer}/"
            f"{'kernel' if leaf == 'weight' else leaf}")
_RANGESEG_UP = re.compile(r"params/ConvTranspose_\d+/kernel$")
_RANGESEG_KEY = re.compile(
    r"(?:params|batch_stats)/(?:"
    r"(?P<stem>ConvBNRelu_0)/(?:Conv_0|BatchNorm_0)"
    r"|(?P<kind>Conv|ConvTranspose|BatchNorm)_(?P<i>\d+)"
    r"|_ResBlock_(?P<j>\d+)/(?:ConvBNRelu_(?P<c>\d+)/(?:Conv_0|BatchNorm_0)"
    r"|(?P<proj>Conv_0)))/(?P<leaf>kernel|bias|scale|mean|var)$")


def _rangeseg_name(key: str, levels: int) -> str:
    """Flat flax key of RangeSegNet -> the port's ``state_dict`` name."""
    m = _RANGESEG_KEY.match(key)
    if m is None:
        raise KeyError(f"no place in the port's model for {key!r}")
    leaf = "weight" if m["leaf"] == "kernel" else m["leaf"]
    if m["stem"]:
        return f"stem.{leaf}"
    if m["j"] is not None:
        inner = "proj" if m["proj"] else f"conv.{m['c']}"
        return f"blocks.{m['j']}.{inner}.{leaf}"
    i = int(m["i"])
    if m["kind"] == "ConvTranspose":
        return f"up.{i}.{leaf}"
    if m["kind"] == "Conv":
        return f"down.{i}.{leaf}" if i < levels else f"head.{leaf}"
    return f"down.{i}.{leaf}" if i < levels else f"up.{i - levels}.{leaf}"


def _rangeseg_flax_key(name: str, levels: int) -> str:
    """RangeSegNet ``state_dict`` name -> flat flax key."""
    parts = name.split(".")
    leaf = parts[-1]
    conv = leaf == "weight"
    col = "batch_stats" if leaf in _BUFFERS else "params"
    if parts[0] == "stem":
        path = "ConvBNRelu_0/" + ("Conv_0" if conv else "BatchNorm_0")
    elif parts[0] == "down":
        path = f"{'Conv' if conv else 'BatchNorm'}_{parts[1]}"
    elif parts[0] == "up":
        path = (f"ConvTranspose_{parts[1]}" if conv
                else f"BatchNorm_{levels + int(parts[1])}")
    elif parts[0] == "head":
        path = f"Conv_{levels}"
    elif parts[2] == "proj":                  # blocks.<j>.proj.weight
        path = f"_ResBlock_{parts[1]}/Conv_0"
    else:                                     # blocks.<j>.conv.<c>.<leaf>
        path = (f"_ResBlock_{parts[1]}/ConvBNRelu_{parts[3]}/"
                + ("Conv_0" if conv else "BatchNorm_0"))
    return f"{col}/{path}/{'kernel' if conv else leaf}"


def _convert_value(key: str, arr: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, np.float32))
    if re.search(r"Dense_\d+/kernel$", key):
        return t.T.contiguous()
    if re.search(r"ConvTranspose_\d+/kernel$", key):
        return t.permute(2, 3, 0, 1).flip(2, 3).contiguous()
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1).contiguous()
    if t.dim() == 5:
        return t.permute(4, 3, 0, 1, 2).contiguous()
    return t


def _modules_name(key: str) -> str:
    """Flat flax key of PointPillarsFused, SECONDNet or PointNet2PartSeg
    (and PointNet2Cls's set abstractions) -> ``state_dict`` name."""
    for pattern, name in _PATTERNS:
        m = pattern.match(key)
        if m:
            return name(m)
    raise KeyError(f"no place in the port's model for {key!r}")


def _pointnet2_cls_name(key: str) -> str:
    """Flat flax key of PointNet2Cls -> ``state_dict`` name."""
    m = _CLS_HEAD.match(key)
    if m is None:
        return _modules_name(key)
    leaf = "weight" if m["leaf"] == "kernel" else m["leaf"]
    kind = "dense" if m["kind"] == "Dense" else "bn"
    return f"head.{kind}.{m['k']}.{leaf}"


_PFN_KEY = re.compile(r"(params|batch_stats)/PillarFeatureNet_0/"
                      r"(Dense_0|BatchNorm_0)/(kernel|scale|bias|mean|var)$")
_PFN_LAYERS = {"Dense_0": "dense", "BatchNorm_0": "bn"}


def _pointpillars_name(key: str) -> str:
    """Flat flax key of the voxel-buffer PointPillars -> ``state_dict``
    name."""
    m = _PFN_KEY.match(key)
    if m is None:
        return _modules_name(key)
    leaf = "weight" if m[3] == "kernel" else m[3]
    return f"pfn.{_PFN_LAYERS[m[2]]}.{leaf}"


def _pointpillars_flax_key(name: str) -> str:
    """Voxel-buffer PointPillars ``state_dict`` name -> flat flax key."""
    part, _, rest = name.partition(".")
    if part != "pfn":
        return _flax_key(name)
    layer, leaf = rest.split(".")
    col = "batch_stats" if leaf in _BUFFERS else "params"
    flax_layer = {v: k for k, v in _PFN_LAYERS.items()}[layer]
    return (f"{col}/PillarFeatureNet_0/{flax_layer}/"
            f"{'kernel' if leaf == 'weight' else leaf}")


def convert_flax_arrays(flat: Dict[str, np.ndarray],
                        keys: Optional[str] = None
                        ) -> Dict[str, torch.Tensor]:
    """Flat flax arrays -> the ``state_dict`` of the port's
    PointPillarsFused, SECONDNet, PointNet2PartSeg or RangeSegNet, or of
    the model whose ``FLAX_KEYS`` is ``keys`` (PointNetCls,
    PointNet2Cls, the voxel-buffer PointPillars).

    Raises KeyError on a key it cannot place."""
    levels = sum(1 for key in flat if _RANGESEG_UP.match(key))
    name = {"pointnet_cls": _pointnet_cls_name,
            "pointnet2_cls": _pointnet2_cls_name,
            "pointpillars": _pointpillars_name}.get(keys)
    if name is None:
        name = ((lambda key: _rangeseg_name(key, levels)) if levels
                else _modules_name)
    return {name(key): _convert_value(key, arr) for key, arr in flat.items()}


def load_weights_npz(model: nn.Module, path: str) -> nn.Module:
    """Load a ``save_weights_npz`` snapshot into ``model`` (in place).

    Strict: a parameter the snapshot does not fill, a key the model does
    not use or a shape that differs raises."""
    with np.load(path) as data:
        state = convert_flax_arrays({k: data[k] for k in data.files},
                                    getattr(model, "FLAX_KEYS", None))
    model.load_state_dict(state, strict=True)
    return model


_POINTNET2_PARTS = {"sa", "global_sa", "fp3", "fp", *_POINTNET2_HEAD.values()}


def _pointnet2_flax_key(name: str) -> str:
    """PointNet++ (part segmentation or classification) ``state_dict``
    name -> flat flax key."""
    part, _, rest = name.partition(".")
    if part in _POINTNET2_HEAD.values():
        layer = {v: k for k, v in _POINTNET2_HEAD.items()}[part]
        owner, leaf = "", rest
    elif part == "head":                   # head.<dense|bn>.<k>.<leaf>
        kind, k, leaf = rest.split(".")
        layer = f"{'Dense' if kind == 'dense' else 'BatchNorm'}_{k}"
        owner = ""
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
    transposed = {f"{n}.weight" for n, m in model.named_modules()
                  if getattr(m, "transpose", False)}
    keys = getattr(model, "FLAX_KEYS", None)
    flax_key = {
        "rangeseg": lambda name: _rangeseg_flax_key(name, len(model.up)),
        "pointnet_cls": _pointnet_cls_flax_key,
        "pointnet2_cls": _pointnet2_flax_key,
        "pointpillars": _pointpillars_flax_key}.get(keys, _flax_key)
    out = {}
    for name, t in (model.state_dict() if tensors is None
                    else tensors).items():
        t = t.detach().cpu().float()
        key = flax_key(name)
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


def state_digests(model: nn.Module) -> Dict[str, str]:
    """The SHA-256 of each ``state_dict`` tensor's bytes (C order, on the
    host), by name: a record of a draw that is small enough to commit."""
    return {name: hashlib.sha256(
                t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for name, t in model.state_dict().items()}
