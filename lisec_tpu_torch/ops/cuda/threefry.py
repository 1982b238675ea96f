"""Dropout masks from the reference's threefry stream, on Hopper.

``bernoulli_mask(key, keep_prob, shape, offset, device)`` is
``jax.random.bernoulli(key, keep_prob, global_shape)`` (JAX 0.9,
partitionable threefry, f32 ``keep_prob``) at the flat elements
``offset .. offset + prod(shape) - 1``, as a bool tensor of ``shape``:
element i is kept where the uniform ``float((y0 ^ y1) >> 9 | 0x3f800000)
- 1`` of ``(y0, y1) = threefry2x32(key, hi(offset + i), lo(offset + i))``
is below ``keep_prob``. ``key`` is the two uint32 words of a JAX key
(``utils.prng``). With ``offset`` 0 it is the mask flax's ``Dropout``
draws for the whole input; a rank of a data mesh passes the flat index
of its first row and gets its rows of that mask alone.

No TPU kernel is replaced: the JAX package draws these bits in XLA
(``nn.Dropout`` at ``lisec_tpu/models/pointnet2.py:146``, ``:174``,
``:178`` and ``lisec_tpu/models/common.py:52``). ``csrc/threefry.cu``
runs one thread per element with the 20 rounds in registers. It is
bound by integer operations, about 85 an element (20 adds, 20 funnel
shifts and 20 xors in the rounds, 15 key injections, the counter's
split, the final xor, shift, or and compare), against one byte written.
In plain torch the same function is some 200 elementwise passes over
int64 tensors.

On the CPU (``device`` "cpu") ``bernoulli_mask`` computes the plain
version ``bernoulli_mask_reference``; on a CUDA device it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import numpy as np
import torch

from lisec_tpu_torch.ops.cuda import build

# Launches of the CUDA kernel since import.
LAUNCHES = 0

KERNEL_INFO = {
    "name": "threefry",
    "route": "cuda",
    "source": "lisec_tpu_torch/csrc/threefry.cu",
    "replaces": "none: XLA's threefry under nn.Dropout, "
                "lisec_tpu/models/pointnet2.py:146",
}

# Integer operations an element, for the bound (see the docstring).
INT_OPS_PER_ELEMENT = 85

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _keep32(keep_prob: float) -> float:
    return float(np.float32(keep_prob))


def bernoulli_mask_reference(key, keep_prob: float, shape: Sequence[int],
                             offset: int = 0, device="cpu") -> torch.Tensor:
    """Plain version of the kernel: threefry on int64 tensors, each word
    masked to 32 bits."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    count = math.prod(shape)
    idx = torch.arange(count, dtype=torch.int64, device=device) + offset
    x0 = ((idx >> 32) + ks[0]) & _MASK32
    x1 = ((idx & _MASK32) + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = (((x1 << r) & _MASK32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    return (u < _keep32(keep_prob)).view(tuple(shape))


_fn = None


def _launch(k0: int, k1: int, keep_prob: float, shape, offset: int,
            device) -> torch.Tensor:
    global LAUNCHES, _fn
    if _fn is None:
        p = ctypes.c_void_p
        _fn = build.bind("threefry", "lisec_threefry_bernoulli",
                         [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64,
                          ctypes.c_int64, ctypes.c_float, p, p])
    out = torch.empty(tuple(shape), dtype=torch.bool, device=device)
    count = out.numel()
    if count == 0:
        return out
    err = _fn(k0, k1, offset, count, _keep32(keep_prob), out.data_ptr(),
              build.stream_of(out))
    if err != 0:
        raise RuntimeError(f"threefry kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def bernoulli_mask(key, keep_prob: float, shape: Sequence[int],
                   offset: int = 0, device="cuda") -> torch.Tensor:
    """The bool mask of ``shape`` that ``jax.random.bernoulli(key,
    keep_prob, ...)`` draws at the flat elements from ``offset`` on. On
    a CPU device the plain version; on a CUDA device one kernel launch."""
    key = np.asarray(key)
    if key.shape != (2,) or key.dtype != np.uint32:
        raise ValueError(f"key must be two uint32 words, got {key!r}")
    if not 0 <= int(offset) < 2 ** 63 - math.prod(shape):
        raise ValueError(f"offset {offset} is out of range")
    dev = torch.device(device)
    if dev.type == "cpu":
        return bernoulli_mask_reference(key, keep_prob, shape, int(offset),
                                        dev)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(int(key[0]), int(key[1]), keep_prob, shape, int(offset),
                   dev)
