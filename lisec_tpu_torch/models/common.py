"""Shared NN blocks (port of ``lisec_tpu/models/common.py``): the
detectors' and the range segmenter's NCHW ``ConvBNRelu`` and ``Conv``,
and the point networks' ``SharedMLP``, ``MLPHead``, ``dropout`` and
``masked_max`` over channels-last rows; ``reset_parameters``, the JAX
package's initial draw.

Parameters are stored in PyTorch's layouts; ``lisec_tpu_torch/weights.py``
converts the flax ones. ``dtype`` is the compute dtype: inputs and
kernels are cast to it per layer, as flax does, and parameters stay f32.
"""

from __future__ import annotations

import functools
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lisec_tpu_torch.ops.cuda.threefry import bernoulli_mask
from lisec_tpu_torch.parallel.mesh import current_mesh, global_mean
from lisec_tpu_torch.utils import prng

BN_EPS = 1e-3
BN_MOMENTUM = 0.99


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def pad_same(x: torch.Tensor, kernel: int, stride) -> torch.Tensor:
    """flax/XLA ``SAME`` padding of NCHW x for a square kernel and a
    stride that is one int or an (H, W) pair: the extra row and column go
    on the high side (a stride-2 3x3 conv on even H, W pads (0, 1))."""
    pads = []
    for size, s in zip((x.shape[-1], x.shape[-2]), _pair(stride)[::-1]):
        total = max((-(-size // s) - 1) * s + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def conv_transpose_same(x: torch.Tensor, weight: torch.Tensor, stride
                        ) -> torch.Tensor:
    """flax's ``ConvTranspose`` with ``SAME`` padding (no kernel
    transpose) of NCHW x, its kernel stored as ``conv_transpose2d``'s
    (in, out, kh, kw) weight, already flipped in space: the full
    transposed conv, cropped along each axis to ``stride * n`` from offset
    ``k - 1 - pad_a``, where ``pad_a`` is the low padding that
    ``lax.conv_transpose`` gives the dilated input (``k - 1`` when the
    stride exceeds ``k - 1``, else ``ceil((k + s - 2) / 2)``). Kernel =
    stride crops nothing; a 3x3 kernel crops from 1 on a stride-1 axis
    and from 0 on a stride-2 axis."""
    strides = _pair(stride)
    y = F.conv_transpose2d(x, weight, stride=strides)
    for axis, (k, s) in enumerate(zip(weight.shape[2:], strides)):
        pad_a = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
        y = y.narrow(2 + axis, k - 1 - pad_a, s * x.shape[2 + axis])
    return y


def batch_norm(xf: torch.Tensor, layer: nn.Module, channel_dim: int, *,
               momentum: float = BN_MOMENTUM, eps: float = BN_EPS
               ) -> torch.Tensor:
    """flax's ``BatchNorm(momentum, epsilon)`` (by default the detectors'
    0.99 and 1e-3) of ``xf`` (f32, or f64 for an f64 model) over every
    axis but ``channel_dim``, with ``layer``'s ``scale``, ``bias`` and
    running ``mean`` and ``var``, written out as flax computes it: in
    ``eval()`` mode with the running statistics; in ``train()`` mode with
    the batch statistics, the variance as E[x^2] - E[x]^2 clipped at 0,
    and that biased variance going into the running statistics
    (``torch.nn.BatchNorm2d`` stores the unbiased one). Under a data
    mesh the batch statistics are those of the global batch
    (``global_mean``), so the running statistics agree on every rank.
    Returns ``xf``'s type; the caller casts."""
    dims = [d for d in range(xf.dim()) if d != channel_dim % xf.dim()]
    shape = [1] * xf.dim()
    shape[channel_dim] = -1
    if layer.training:
        mean, ex2 = global_mean([xf, xf * xf], dims)
        var = (ex2 - mean * mean).clamp_min(0)
        with torch.no_grad():
            layer.mean.mul_(momentum).add_((1.0 - momentum) * mean)
            layer.var.mul_(momentum).add_((1.0 - momentum) * var)
    else:
        mean, var = layer.mean, layer.var
    mul = torch.rsqrt(var + eps) * layer.scale
    return (xf - mean.view(shape)) * mul.view(shape) + layer.bias.view(shape)


# The order in which a flax module calls ``self.param`` for its leaves:
# flax keys the initializer of a module's n-th param with counter n.
_PARAM_ORDER = ("kernel", "scale", "bias")


def flax_initializer(model, key: str) -> prng.Initializer:
    """The flax initializer of the parameter at flat flax key ``key``
    (``params/<module path>/<leaf>``) of a model or model class: the
    first of its ``FLAX_INITS`` (pairs of a key regex and an
    initializer) that matches, else flax's defaults, ``lecun_normal``
    for a kernel, zeros for a bias, ones for a BatchNorm scale."""
    for pattern, init in getattr(model, "FLAX_INITS", ()):
        if re.search(pattern, key):
            return init
    leaf = key.rsplit("/", 1)[1]
    return {"kernel": prng.lecun_normal(), "bias": prng.zeros,
            "scale": prng.ones}[leaf]


@functools.lru_cache(maxsize=4)
def _flax_draw(model_type: type, seed: int,
               layout: Tuple[Tuple[str, Tuple[int, ...]], ...]
               ) -> Dict[str, np.ndarray]:
    """The flat flax arrays of ``reset_parameters`` for a model of
    ``model_type`` whose flat flax keys and shapes are ``layout``. The
    few latest draws are kept: a pipeline draws its seed's weights when
    it is built and again in ``init_state``."""
    root = prng.PRNGKey(seed)
    leaves: Dict[Tuple[str, ...], list] = {}
    for key, _ in layout:
        col, *path, leaf = key.split("/")
        if col == "params":
            leaves.setdefault(tuple(path), []).append(leaf)
    flat = {}
    for key, shape in layout:
        col, *path, leaf = key.split("/")
        if col == "batch_stats":
            flat[key] = np.full(shape, 1.0 if leaf == "var" else 0.0,
                                np.float32)
            continue
        order = sorted(leaves[tuple(path)], key=_PARAM_ORDER.index)
        counter = order.index(leaf) + 1
        flat[key] = flax_initializer(model_type, key)(
            prng.fold_in_static(root, (*path, counter)), shape)
    return flat


@torch.no_grad()
def reset_parameters(model: nn.Module, seed: int) -> None:
    """The JAX package's initial weights from ``seed``: every parameter
    drawn in its flax layout by its flax initializer (``flax_initializer``)
    under the key flax gives it, ``fold_in_static(PRNGKey(seed), module
    path + (n,))`` for the module's n-th ``self.param`` (kernel, then
    BatchNorm scale, then bias), and carried into the model's layouts by
    ``weights.convert_flax_arrays``; running statistics (0, 1). The draw
    is in f32 on the host (``utils.prng``), the same on every host; an
    f64 model takes it cast, as JAX's f32 parameters would be."""
    from lisec_tpu_torch.weights import convert_flax_arrays, to_flax_arrays
    layout = tuple((k, v.shape) for k, v in to_flax_arrays(model).items())
    flat = _flax_draw(type(model), int(seed), layout)
    model.load_state_dict(
        convert_flax_arrays(flat, getattr(model, "FLAX_KEYS", None)))


class ConvBNRelu(nn.Module):
    """2D conv (or transposed conv) + BatchNorm + ReLU, ``SAME`` padded,
    with a square kernel and a stride that is one int or an (H, W) pair.

    BatchNorm is :func:`batch_norm`, in f32 (f64 for an f64 model).

    The conv weight is (out, in, k, k); the transposed conv's is
    (in, out, k, k), already spatially flipped, so that
    :func:`conv_transpose_same` equals flax's ``ConvTranspose``.
    """

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride=1, transpose: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.transpose, self.dtype = transpose, dtype
        shape = ((in_features, features) if transpose
                 else (features, in_features)) + (kernel, kernel)
        self.weight = nn.Parameter(torch.zeros(shape))
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        if self.transpose:
            x = conv_transpose_same(x, w, self.stride)
        else:
            x = F.conv2d(pad_same(x, self.kernel, self.stride), w,
                         stride=self.stride)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        return torch.relu(batch_norm(xf, self, 1).to(self.dtype))


class Conv(nn.Module):
    """flax's ``nn.Conv`` with a square kernel, stride 1 and ``SAME``
    padding, with or without a bias. ``dtype`` None computes as flax does
    with no dtype: in the promotion of the input and the f32 parameters,
    so in f32."""

    def __init__(self, in_features: int, features: int, kernel: int = 1,
                 bias: bool = True, dtype=None):
        super().__init__()
        self.kernel, self.dtype = kernel, dtype
        self.weight = nn.Parameter(
            torch.zeros((features, in_features, kernel, kernel)))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or torch.promote_types(x.dtype, torch.float32)
        x = pad_same(x.to(dtype), self.kernel, 1)
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.conv2d(x, self.weight.to(dtype), bias)


# -- point networks (channels last) -------------------------------------------

POINT_BN_MOMENTUM = 0.9     # flax BatchNorm(momentum=0.9), eps 1e-5
POINT_BN_EPS = 1e-5


class Dense(nn.Linear):
    """flax's ``nn.Dense``: ``x @ kernel (+ bias)``, its (in, out) kernel
    stored as ``nn.Linear``'s (out, in) weight."""


class BatchNorm(nn.Module):
    """Parameters and running statistics of one flax ``BatchNorm`` over
    the last axis, applied by :func:`batch_norm` with the point networks'
    momentum 0.9 and eps 1e-5, in the type flax infers from the input's
    and the parameters' (f32 for a bf16 or f32 input to f32 parameters,
    f64 for an f64 model)."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, self.scale.dtype))
        return batch_norm(xf, self, -1, momentum=POINT_BN_MOMENTUM,
                          eps=POINT_BN_EPS)


class SharedMLP(nn.Module):
    """Pointwise MLP over the last axis: per layer Dense (no bias, as BN
    follows), BatchNorm, ReLU."""

    def __init__(self, in_features: int, features):
        super().__init__()
        widths = [in_features, *features]
        self.dense = nn.ModuleList(
            Dense(a, b, bias=False) for a, b in zip(widths, widths[1:]))
        self.bn = nn.ModuleList(BatchNorm(f) for f in features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for dense, bn in zip(self.dense, self.bn):
            x = torch.relu(bn(dense(x)))
        return x


def dropout(h: torch.Tensor, rate: float, key: Optional[np.ndarray]
            ) -> torch.Tensor:
    """flax's ``Dropout(rate)`` in training: ``h`` kept where
    ``jax.random.bernoulli(key, 1 - rate, global shape)`` is true (the
    ``threefry`` kernel on the card) and scaled by the f32 reciprocal of
    1 - rate, as the JAX package's jitted train step computes ``x /
    keep``; 0 elsewhere. ``key`` is the layer's, ``fold_in_static(step
    key, flax path + (1,))``. Under a data mesh this rank draws only its
    rows, from the flat index of its first: the single-device mask, as
    the stream is partitionable."""
    if rate == 0.0:
        return h
    if key is None:
        raise ValueError("dropout in training needs the step's key")
    keep_prob = 1.0 - rate
    mesh = current_mesh()
    keep = bernoulli_mask(key, keep_prob, h.shape,
                          offset=mesh.rank * h.numel(), device=h.device)
    one = np.ones((), np.float64 if h.dtype == torch.float64
                  else np.float32)
    return torch.where(keep, h * float(one / one.dtype.type(keep_prob)),
                       0.0)


def dropout_key(rng: Optional[np.ndarray], path: Sequence[str]
                ) -> Optional[np.ndarray]:
    """The key flax's ``Dropout`` at module path ``path`` draws from under
    the step key ``rng``: its first ``make_rng("dropout")``."""
    return None if rng is None else prng.fold_in_static(rng, (*path, 1))


class MLPHead(nn.Module):
    """FC head: per hidden width a Dense (without a bias, as BN follows,
    unless ``hidden_bias``), BatchNorm, ReLU and dropout (rate
    ``dropout_rate``, in ``train()`` mode only, its k-th layer keyed as
    flax's ``<flax_path>/Dropout_k`` under the step key the caller
    passes), then a final Dense with a bias."""

    def __init__(self, in_features: int, features: Sequence[int],
                 out_dim: int, dropout_rate: float = 0.4,
                 hidden_bias: bool = False,
                 flax_path: Tuple[str, ...] = ("MLPHead_0",)):
        super().__init__()
        widths = [in_features, *features]
        self.dense = nn.ModuleList(
            [Dense(a, b, bias=hidden_bias)
             for a, b in zip(widths, widths[1:])]
            + [Dense(widths[-1], out_dim)])
        self.bn = nn.ModuleList(BatchNorm(f) for f in features)
        self.dropout_rate = dropout_rate
        self.flax_path = tuple(flax_path)

    def forward(self, x: torch.Tensor, rng: Optional[np.ndarray] = None
                ) -> torch.Tensor:
        for k, (dense, bn) in enumerate(zip(self.dense, self.bn)):
            x = torch.relu(bn(dense(x)))
            if self.training:
                x = dropout(x, self.dropout_rate, dropout_key(
                    rng, (*self.flax_path, f"Dropout_{k}")))
        return self.dense[-1](x)


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim: int
               ) -> torch.Tensor:
    """Max over ``dim`` of x (..., N, C) counting only rows whose mask
    (..., N) is set; 0 where none is. ``dim`` must not be the channel
    axis."""
    dim = dim % x.dim()
    neg = torch.finfo(x.dtype).min
    y = torch.where(mask.bool()[..., None], x, neg).amax(dim=dim)
    return torch.where(mask.bool().any(dim=dim)[..., None], y, 0.0)
