"""Carry the JAX package's weights into the port, and back.

The JAX package dumps ``params`` and ``batch_stats`` as flat npz keys
(``lisec_tpu/bench_lib.py::save_weights_npz``), e.g.
``params/BEVBackbone_0/ConvBNRelu_11/ConvTranspose_0/kernel`` or
``batch_stats/FusedPillarEncoder_0/mean``. Each model family's map onto
the port's ``state_dict`` names is written once, as a table of rules in
``_FAMILIES``, keyed by the model's ``FLAX_KEYS`` (None for
PointPillarsFused, SECONDNet and PointNet2PartSeg, which have none). A
rule pairs a flax key pattern (below its collection) with a name pattern
over shared fields, and names the layout of its kernel:

    ("SparseMiddleEncoder_0/Conv_{i}/kernel", "encoder.dense.{i}.weight",
     CONV3D)

``convert_flax_arrays`` parses each key by the first rule of the family
that matches it and formats the name; ``to_flax_arrays`` parses the name
and formats the key. The fields:

* ``{i}``, ``{j}``, ``{k}``, ``{c}``: an index, the same on both sides;
* ``{leaf}``: a norm's or a bias's leaf (``scale``, ``bias``, ``mean``,
  ``var``, ``conv_bias``), the same on both sides;
* ``{param}``: a layer's ``kernel`` or ``bias``, named ``weight`` or
  ``bias`` in the port;
* ``{path}``: a module path, ``/``-separated in flax, ``.`` in the port
  (CenterPoint, which the JAX package does not have, takes its keys from
  its module paths);
* ``{L}`` and ``{Li}``: range segmentation's maps by position. L is its
  level count (the number of top-level ``ConvTranspose_i`` kernels, or
  of ``up`` layers); ``{L}`` is L on the flax side, and ``{Li}`` is L + i
  on the flax side and i in the port (the up path's ``BatchNorm_{L + i}``
  is ``up.i``).

The collection is ``batch_stats`` for ``mean`` and ``var``, ``params``
for every other leaf. A rule's layout is a pair, flax to port and back,
applied to its ``kernel``; every other leaf is carried as it is:

* CONV: (kh, kw, in, out) -> (out, in, kh, kw);
* CONV_T: (kh, kw, in, out) -> (in, out, kh, kw), flipped in space
  (flax's ``ConvTranspose`` does not flip the kernel,
  ``conv_transpose2d`` does);
* CONV3D: SECOND's dense 3D convs, (kd, kh, kw, in, out) ->
  (out, in, kd, kh, kw);
* DENSE: (in, out) -> ``nn.Linear``'s (out, in);
* AS_IS: the pillar encoder's (9, C) and the sparse convs' (K, Cin, Cout).

The BEV backbone's layers are ``Conv_0`` or ``ConvTranspose_0`` under the
same name: on the way back a name takes the CONV_T rule exactly when its
module's ``transpose`` flag is set. Without ``keys``,
``convert_flax_arrays`` takes range segmentation's map when the keys hold
a top-level ``ConvTranspose_i``, else the None family's.

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

# Kernel layouts: (flax -> port, port -> flax).
AS_IS = (lambda t: t, lambda t: t)
DENSE = (lambda t: t.T, lambda t: t.T)
CONV = (lambda t: t.permute(3, 2, 0, 1), lambda t: t.permute(2, 3, 1, 0))
CONV_T = (lambda t: t.permute(2, 3, 0, 1).flip(2, 3),
          lambda t: t.flip(2, 3).permute(2, 3, 0, 1))
CONV3D = (lambda t: t.permute(4, 3, 0, 1, 2),
          lambda t: t.permute(2, 3, 4, 1, 0))

# A field's pattern (flax side, port side); any other field is an index.
_FIELDS = {"leaf": ("scale|bias|mean|var|conv_bias",) * 2,
           "param": ("kernel|bias", "weight|bias"),
           "path": (r"\w+(?:/\w+)*", r"\w+(?:\.\w+)*")}
_INDEX = (r"\d+", r"\d+")


def _conv_bn(flax, port, kernel="Conv_0/kernel", kind=CONV):
    """A conv and its BatchNorm_0 (flax's ConvBNRelu)."""
    return [(flax + kernel, port + "weight", kind),
            (flax + "BatchNorm_0/{leaf}", port + "{leaf}", AS_IS)]


def _mlp(flax, port):
    """The Dense_k and BatchNorm_k of a SharedMLP or an MLP head."""
    return [(flax + "Dense_{k}/{param}", port + "dense.{k}.{param}", DENSE),
            (flax + "BatchNorm_{k}/{leaf}", port + "bn.{k}.{leaf}", AS_IS)]


_BEV = [*_conv_bn("BEVBackbone_0/ConvBNRelu_{i}/", "backbone.layers.{i}."),
        ("BEVBackbone_0/ConvBNRelu_{i}/ConvTranspose_0/kernel",
         "backbone.layers.{i}.weight", CONV_T)]
_ANCHOR_HEAD = [("AnchorHead_0/Conv_0/{param}", "head.cls.{param}", CONV),
                ("AnchorHead_0/Conv_1/{param}", "head.box.{param}", CONV),
                ("AnchorHead_0/Conv_2/{param}", "head.dir.{param}", CONV)]
_SET_ABSTRACTION = [
    *_mlp("SetAbstraction_{i}/SharedMLP_{j}/", "sa.{i}.mlps.{j}."),
    *_mlp("GlobalSetAbstraction_0/SharedMLP_0/", "global_sa.mlp.")]

_RULES = {
    None: [  # PointPillarsFused, SECONDNet, PointNet2PartSeg
        ("FusedPillarEncoder_0/kernel", "encoder.kernel", AS_IS),
        ("FusedPillarEncoder_0/{leaf}", "encoder.{leaf}", AS_IS),
        *_conv_bn("SparseMiddleEncoder_0/SparseConv3D_{i}/",
                  "encoder.sparse.{i}.", "kernel", AS_IS),
        ("SparseMiddleEncoder_0/Conv_{i}/kernel", "encoder.dense.{i}.weight",
         CONV3D),
        ("SparseMiddleEncoder_0/MaskedBatchNorm_{i}/{leaf}",
         "encoder.dense.{i}.{leaf}", AS_IS),
        *_BEV, *_ANCHOR_HEAD, *_SET_ABSTRACTION,
        *_mlp("SharedMLP_0/", "fp3."),
        *_mlp("FeaturePropagation_{i}/SharedMLP_0/", "fp.{i}.mlp."),
        ("Dense_0/{param}", "head_dense.{param}", DENSE),
        ("BatchNorm_0/{leaf}", "head_bn.{leaf}", AS_IS),
        ("Dense_1/{param}", "head_out.{param}", DENSE)],
    "pointpillars": [  # the voxel-buffer PointPillars
        ("PillarFeatureNet_0/Dense_0/{param}", "pfn.dense.{param}", DENSE),
        ("PillarFeatureNet_0/BatchNorm_0/{leaf}", "pfn.bn.{leaf}", AS_IS),
        *_BEV, *_ANCHOR_HEAD],
    "pointnet_cls": [
        *_mlp("TNet_{i}/SharedMLP_{j}/", "tnets.{i}.mlps.{j}."),
        ("TNet_{i}/Dense_0/{param}", "tnets.{i}.out.{param}", DENSE),
        *_mlp("SharedMLP_{j}/", "mlps.{j}."),
        *_mlp("MLPHead_0/", "head.")],
    "pointnet2_cls": [*_SET_ABSTRACTION, *_mlp("", "head.")],
    "rangeseg": [
        *_conv_bn("ConvBNRelu_0/", "stem."),
        ("Conv_{L}/{param}", "head.{param}", CONV),
        ("Conv_{i}/kernel", "down.{i}.weight", CONV),
        ("BatchNorm_{Li}/{leaf}", "up.{Li}.{leaf}", AS_IS),
        ("BatchNorm_{i}/{leaf}", "down.{i}.{leaf}", AS_IS),
        ("ConvTranspose_{i}/kernel", "up.{i}.weight", CONV_T),
        *_conv_bn("_ResBlock_{j}/ConvBNRelu_{c}/", "blocks.{j}.conv.{c}."),
        ("_ResBlock_{j}/Conv_0/kernel", "blocks.{j}.proj.weight", CONV)],
    "centerpoint": [
        *_BEV,
        ("encoder/{path}/kernel", "encoder.{path}.weight", AS_IS),
        ("head/{path}/kernel", "head.{path}.weight", CONV),
        ("{path}/{leaf}", "{path}.{leaf}", AS_IS)],
}


def _pattern(text: str, side: int) -> "re.Pattern":
    return re.compile(re.sub(
        r"\{(\w+)\}",
        lambda m: f"(?P<{m[1]}>{_FIELDS.get(m[1], _INDEX)[side]})",
        text.replace(".", r"\.")))


# Each family's rules as ((flax regex, port regex), (flax, port), kind).
_FAMILIES = {keys: [((_pattern(flax, 0), _pattern(port, 1)), (flax, port),
                     kind) for flax, port, kind in rules]
             for keys, rules in _RULES.items()}


def _field(field: str, value: str, levels: int, to_port: bool):
    """A field's value on the other side (None: the rule does not
    apply)."""
    if field == "param":
        return {"kernel": "weight", "weight": "kernel"}.get(value, value)
    if field == "path":
        return (value.replace("/", ".") if to_port
                else value.replace(".", "/"))
    if field == "Li":
        i = int(value) + (-levels if to_port else levels)
        return str(i) if i >= 0 else None
    if field == "L" and int(value) != levels:
        return None
    return value


def _translate(keys: Optional[str], text: str, to_port: bool,
               levels: int = 0, transposed: bool = False):
    """A flax key below its collection -> a ``state_dict`` name, or the
    reverse, by the first rule of family ``keys`` that matches, and the
    rule's layout; None if no rule matches."""
    side = 0 if to_port else 1
    for patterns, templates, kind in _FAMILIES[keys]:
        if not to_port and (kind is CONV_T) != transposed:
            continue
        m = patterns[side].fullmatch(text)
        if m is None:
            continue
        fields = {f: _field(f, v, levels, to_port)
                  for f, v in m.groupdict().items()}
        if None not in fields.values():
            return templates[1 - side].format(**{"L": levels, **fields}), kind
    return None


def _collection(path: str) -> str:
    return ("batch_stats" if path.rsplit("/", 1)[-1] in ("mean", "var")
            else "params")


def convert_flax_arrays(flat: Dict[str, np.ndarray],
                        keys: Optional[str] = None
                        ) -> Dict[str, torch.Tensor]:
    """Flat flax arrays -> the ``state_dict`` of the port's
    PointPillarsFused, SECONDNet, PointNet2PartSeg or RangeSegNet, or of
    the model whose ``FLAX_KEYS`` is ``keys`` (PointNetCls,
    PointNet2Cls, the voxel-buffer PointPillars, CenterPoint).

    Raises KeyError on a key it cannot place."""
    levels = sum(1 for key in flat
                 if re.fullmatch(r"params/ConvTranspose_\d+/kernel", key))
    if keys is None and levels:
        keys = "rangeseg"
    out = {}
    for key, arr in flat.items():
        col, _, path = key.partition("/")
        hit = _translate(keys, path, True, levels)
        if hit is None or col != _collection(path):
            raise KeyError(f"no place in the port's model for {key!r}")
        name, kind = hit
        t = torch.from_numpy(np.array(arr, np.float32))
        out[name] = (kind[0](t) if path.endswith("/kernel")
                     else t).contiguous()
    return out


def load_weights_npz(model: nn.Module, path: str) -> nn.Module:
    """Load a ``save_weights_npz`` snapshot into ``model`` (in place).

    Strict: a parameter the snapshot does not fill, a key the model does
    not use or a shape that differs raises."""
    with np.load(path) as data:
        state = convert_flax_arrays({k: data[k] for k in data.files},
                                    getattr(model, "FLAX_KEYS", None))
    model.load_state_dict(state, strict=True)
    return model


def to_flax_arrays(model: nn.Module,
                   tensors: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`convert_flax_arrays`: the model's
    ``state_dict`` as flat ``params/...`` and ``batch_stats/...`` numpy
    arrays in flax layouts. ``tensors`` (same names and layouts as the
    ``state_dict``, e.g. the parameters' gradients) is converted instead
    when given."""
    keys = getattr(model, "FLAX_KEYS", None)
    levels = len(model.up) if keys == "rangeseg" else 0
    transposed = {f"{n}.weight" for n, m in model.named_modules()
                  if getattr(m, "transpose", False)}
    out = {}
    for name, t in (model.state_dict() if tensors is None
                    else tensors).items():
        hit = _translate(keys, name, False, levels, name in transposed)
        if hit is None:
            raise KeyError(f"no flax key for {name!r}")
        path, kind = hit
        t = t.detach().cpu().float()
        if path.endswith("/kernel"):
            t = kind[1](t)
        out[f"{_collection(path)}/{path}"] = t.contiguous().numpy()
    return out


def state_digests(model: nn.Module) -> Dict[str, str]:
    """The SHA-256 of each ``state_dict`` tensor's bytes (C order, on the
    host), by name: a record of a draw that is small enough to commit."""
    return {name: hashlib.sha256(
                t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for name, t in model.state_dict().items()}
