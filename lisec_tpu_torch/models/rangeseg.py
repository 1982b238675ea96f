"""Range-image semantic segmentation network (port of
``lisec_tpu/models/rangeseg.py``).

A RangeNet/SalsaNext-style 2D encoder-decoder over the spherical
projection (H x W, 5 channels: range, x, y, z, remission) with skip
connections. Downsampling is width-heavy ((1, 2) strides after the first
level) because lidar range images are much wider than tall; the decoder
mirrors it with 3x3 transposed convs.

Module names and the flax ones (``lisec_tpu_torch/weights.py`` maps
them): ``stem`` is ``ConvBNRelu_0``; ``down.i`` is ``Conv_i`` with
``BatchNorm_i``; ``up.i`` is ``ConvTranspose_i`` with
``BatchNorm_{L + i}`` (L levels); ``blocks.j`` is ``_ResBlock_j`` (the
encoder's first, then the decoder's), inside it ``conv.c`` is
``ConvBNRelu_c`` and ``proj`` the 1x1 ``Conv_0``; ``head`` is
``Conv_L``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from lisec_tpu_torch.models.common import Conv, ConvBNRelu, reset_parameters


class ResBlock(nn.Module):
    """Two 3x3 ConvBNRelu and a residual, through a bias-free 1x1 conv
    where the width changes."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.ModuleList([
            ConvBNRelu(in_features, features, 3, dtype=dtype),
            ConvBNRelu(features, features, 3, dtype=dtype)])
        self.proj = (Conv(in_features, features, 1, bias=False, dtype=dtype)
                     if in_features != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv[1](self.conv[0](x))
        if self.proj is not None:
            x = self.proj(x)
        return x + h


class RangeSegNet(nn.Module):
    """Encoder-decoder with skip connections over the range image:
    image (B, H, W, 5) -> logits (B, H, W, num_classes) f32. The head is
    a 1x1 conv with a bias that computes in f32 whatever ``dtype`` is, as
    the flax head has no dtype."""

    FLAX_KEYS = "rangeseg"  # its key map in ``weights.py``

    def __init__(self, num_classes: int = 20,
                 widths: Sequence[int] = (32, 64, 128, 256),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        widths = list(widths)
        levels = len(widths) - 1
        self.stem = ConvBNRelu(5, widths[0], 3, dtype=dtype)
        self.down = nn.ModuleList(
            ConvBNRelu(widths[i], widths[i + 1], 3,
                       stride=(2, 2) if i == 0 else (1, 2), dtype=dtype)
            for i in range(levels))
        self.up = nn.ModuleList(
            ConvBNRelu(widths[levels - i], widths[levels - i - 1], 3,
                       stride=(1, 2) if i < levels - 1 else (2, 2),
                       transpose=True, dtype=dtype)
            for i in range(levels))
        self.blocks = nn.ModuleList(
            [ResBlock(w, w, dtype) for w in widths[1:]]
            + [ResBlock(widths[levels - i - 1], widths[levels - i - 1],
                        dtype) for i in range(levels)])
        self.head = Conv(widths[0], num_classes, 1)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = self.stem(image.permute(0, 3, 1, 2).to(self.dtype))
        levels = len(self.down)
        skips = []
        for i, down in enumerate(self.down):
            skips.append(x)
            x = self.blocks[i](down(x))
        for i, (up, skip) in enumerate(zip(self.up, reversed(skips))):
            x = self.blocks[levels + i](up(x) + skip)
        x = self.head(x)
        return x.to(torch.promote_types(x.dtype, torch.float32)
                    ).permute(0, 2, 3, 1)

    def reset_parameters(self, seed: int) -> None:
        """The JAX package's initial weights from ``seed``
        (``models.common.reset_parameters``)."""
        reset_parameters(self, seed)
