"""Shared NN blocks (port of ``lisec_tpu/models/common.py``): the
detectors' and the range segmenter's NCHW ``ConvBNRelu`` and ``Conv``,
and the point networks' ``SharedMLP``, ``MLPHead``, ``dropout`` and
``masked_max`` over channels-last rows.

Parameters are stored in PyTorch's layouts; ``lisec_tpu_torch/weights.py``
converts the flax ones. ``dtype`` is the compute dtype: inputs and
kernels are cast to it per layer, as flax does, and parameters stay f32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lisec_tpu_torch.parallel.mesh import current_mesh, global_mean

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


@torch.no_grad()
def reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Fresh weights: every kernel normal with its
    module's ``weight_std()`` (flax's initializers without their
    truncation), drawn on the CPU from ``generator`` in parameter order;
    BN scales 1, every bias 0, running statistics (0, 1)."""
    for name, p in model.named_parameters():
        module, leaf = name.rsplit(".", 1)
        if p.dim() < 2:
            p.fill_(1.0 if leaf == "scale" else 0.0)
            continue
        std = model.get_submodule(module).weight_std()
        p.copy_(torch.empty(p.shape).normal_(0.0, std, generator=generator))
    for name, buf in model.named_buffers():
        buf.fill_(1.0 if name.endswith("var") else 0.0)


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

    def weight_std(self) -> float:
        """flax's lecun-normal: variance 1 / fan_in."""
        w = self.weight
        fan_in = (w.shape[0] * w.shape[2] * w.shape[3] if self.transpose
                  else w[0].numel())
        return fan_in ** -0.5


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

    def weight_std(self) -> float:
        """flax's lecun-normal: variance 1 / fan_in."""
        return self.weight[0].numel() ** -0.5


# -- point networks (channels last) -------------------------------------------

POINT_BN_MOMENTUM = 0.9     # flax BatchNorm(momentum=0.9), eps 1e-5
POINT_BN_EPS = 1e-5


class Dense(nn.Linear):
    """flax's ``nn.Dense``: ``x @ kernel (+ bias)``, its (in, out) kernel
    stored as ``nn.Linear``'s (out, in) weight."""

    def weight_std(self) -> float:
        """flax's lecun-normal: variance 1 / fan_in."""
        return self.in_features ** -0.5


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


def dropout(h: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``Dropout(rate)`` in training: keep with probability
    1 - rate, scale by 1 / (1 - rate), the mask drawn from ``generator``
    on ``h``'s device (torch cannot draw flax's bits). Under a data mesh
    the mask is drawn for the global batch and this rank keeps its rows:
    the masks of the single-device step, and the generator stays in step
    on every rank."""
    if rate == 0.0:
        return h
    keep_prob = 1.0 - rate
    mesh = current_mesh()
    keep = torch.rand((h.shape[0] * mesh.world, *h.shape[1:]),
                      generator=generator, device=h.device) < keep_prob
    keep = mesh.rows(keep)
    return torch.where(keep, h / keep_prob, 0.0)


class MLPHead(nn.Module):
    """FC head: per hidden width a Dense (without a bias, as BN follows,
    unless ``hidden_bias``), BatchNorm, ReLU and dropout (rate
    ``dropout_rate``, in ``train()`` mode only, from the ``generator``
    the caller passes), then a final Dense with a bias."""

    def __init__(self, in_features: int, features: Sequence[int],
                 out_dim: int, dropout_rate: float = 0.4,
                 hidden_bias: bool = False):
        super().__init__()
        widths = [in_features, *features]
        self.dense = nn.ModuleList(
            [Dense(a, b, bias=hidden_bias)
             for a, b in zip(widths, widths[1:])]
            + [Dense(widths[-1], out_dim)])
        self.bn = nn.ModuleList(BatchNorm(f) for f in features)
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        for dense, bn in zip(self.dense, self.bn):
            x = torch.relu(bn(dense(x)))
            if self.training:
                x = dropout(x, self.dropout_rate, generator)
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
