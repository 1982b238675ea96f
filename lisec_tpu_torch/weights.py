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
* everything else (encoder kernel (9, C), BN scale/bias/mean/var, head
  biases) as it is.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

_HEAD = {"Conv_0": "cls", "Conv_1": "box", "Conv_2": "dir"}
_PATTERNS = (
    (re.compile(r"(params|batch_stats)/FusedPillarEncoder_0/"
                r"(kernel|scale|bias|mean|var)$"),
     lambda m: f"encoder.{m[2]}"),
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
    return t


def convert_flax_arrays(flat: Dict[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
    """Flat flax arrays -> the port's PointPillarsFused ``state_dict``.

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
