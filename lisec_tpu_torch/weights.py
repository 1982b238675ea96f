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
* everything else (encoder kernel (9, C), sparse conv kernels
  (K, Cin, Cout), BN scale/bias/mean/var, head biases) as it is.

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
)


def _convert_value(key: str, arr: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, np.float32))
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
    PointPillarsFused or SECONDNet.

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


def _flax_key(name: str) -> str:
    """``state_dict`` name -> flat flax key."""
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
                  if layer.transpose}
    out = {}
    for name, t in (model.state_dict() if tensors is None
                    else tensors).items():
        t = t.detach().cpu().float()
        key = _flax_key(name)
        if name in transposed:                     # undo flip and permute
            t = t.flip(2, 3).permute(2, 3, 0, 1)
            key = key.format(conv="ConvTranspose_0")
        elif t.dim() == 4:
            t = t.permute(2, 3, 1, 0)
            key = key.format(conv="Conv_0")
        elif t.dim() == 5:
            t = t.permute(2, 3, 4, 1, 0)
        out[key] = t.contiguous().numpy()
    return out
