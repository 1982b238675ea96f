"""Shared NN blocks (port of ``lisec_tpu/models/common.py``), NCHW.

Parameters are stored in PyTorch's layouts; ``lisec_tpu_torch/weights.py``
converts the flax ones. ``dtype`` is the compute dtype: inputs and
kernels are cast to it per layer, as flax does, and parameters stay f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.99


def pad_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """flax/XLA ``SAME`` padding of NCHW x: the extra row and column go
    on the high side (a stride-2 3x3 conv on even H, W pads (0, 1))."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def batch_norm(xf: torch.Tensor, layer: nn.Module,
               channel_dim: int) -> torch.Tensor:
    """flax's ``BatchNorm(momentum=0.99, epsilon=1e-3)`` of f32 ``xf``
    over every axis but ``channel_dim``, with ``layer``'s ``scale``,
    ``bias`` and running ``mean`` and ``var``, written out as flax
    computes it: in ``eval()`` mode with the running statistics; in
    ``train()`` mode with the batch statistics, the variance as
    E[x^2] - E[x]^2 clipped at 0, and that biased variance going into the
    running statistics with momentum 0.99 (``torch.nn.BatchNorm2d``
    stores the unbiased one). Returns f32; the caller casts."""
    dims = [d for d in range(xf.dim()) if d != channel_dim % xf.dim()]
    shape = [1] * xf.dim()
    shape[channel_dim] = -1
    if layer.training:
        mean = xf.mean(dim=dims)
        var = ((xf * xf).mean(dim=dims) - mean * mean).clamp_min(0)
        with torch.no_grad():
            layer.mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean)
            layer.var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
    else:
        mean, var = layer.mean, layer.var
    mul = torch.rsqrt(var + BN_EPS) * layer.scale
    return (xf - mean.view(shape)) * mul.view(shape) + layer.bias.view(shape)


@torch.no_grad()
def reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Fresh weights for a detector: every kernel normal with its
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
    """2D conv (or transposed conv) + BatchNorm + ReLU.

    BatchNorm is :func:`batch_norm`.

    The conv weight is (out, in, k, k); the transposed conv's is
    (in, out, k, k), already spatially flipped, so that
    ``conv_transpose2d(x, weight, stride=k)`` equals flax's
    ``ConvTranspose`` with kernel = stride and ``SAME`` padding.
    """

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, transpose: bool = False,
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
            x = F.conv_transpose2d(x, w, stride=self.stride)
        else:
            x = F.conv2d(pad_same(x, self.kernel, self.stride), w,
                         stride=self.stride)
        return torch.relu(batch_norm(x.float(), self, 1).to(self.dtype))

    def weight_std(self) -> float:
        """flax's lecun-normal: variance 1 / fan_in."""
        w = self.weight
        fan_in = (w.shape[0] * w.shape[2] * w.shape[3] if self.transpose
                  else w[0].numel())
        return fan_in ** -0.5
