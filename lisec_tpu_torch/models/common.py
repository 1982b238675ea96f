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


class ConvBNRelu(nn.Module):
    """2D conv (or transposed conv) + BatchNorm + ReLU.

    BatchNorm is written out as flax's ``BatchNorm(momentum=0.99,
    epsilon=1e-3)`` computes it: in ``eval()`` mode with the running
    statistics; in ``train()`` mode with the batch statistics in f32, the
    variance as E[x^2] - E[x]^2 clipped at 0, and that biased variance
    going into the running statistics with momentum 0.99
    (``torch.nn.BatchNorm2d`` stores the unbiased one).

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
        # flax's BatchNorm computes in f32 and returns the compute dtype.
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0)
            with torch.no_grad():
                self.mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean)
                self.var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        y = y + self.bias[:, None, None]
        return torch.relu(y.to(self.dtype))
