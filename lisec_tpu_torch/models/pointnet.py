"""PointNet classifier (port of ``lisec_tpu/models/pointnet.py``).

Input T-Net (3x3), shared MLP (64, 64), feature T-Net (64x64), shared
MLP (64, 128, 1024), masked global max-pool, FC (512, 256, classes) with
BatchNorm and dropout, and the orthogonality regulariser on the feature
transform. No kernel runs here: the layers are dense products, and the
two point-by-transform products are batched matmuls, as the JAX package
left its ``einsum`` to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lisec_tpu_torch.models.common import (
    Dense, MLPHead, SharedMLP, masked_max, reset_parameters)
from lisec_tpu_torch.parallel.mesh import mean_share


class _ZeroInitDense(Dense):
    """A Dense that fresh weights leave at zero (flax's ``zeros``
    initialiser): the T-Net's last layer, so that it starts as the
    identity."""

    def weight_std(self) -> float:
        return 0.0


class TNet(nn.Module):
    """Predicts a k x k alignment matrix from (B, N, k) points: shared MLP
    (64, 128, 1024), masked max over the points, shared MLP (512, 256) on
    the (B, 1024) rows, a Dense to k * k plus the identity."""

    def __init__(self, k: int):
        super().__init__()
        self.k = k
        self.mlps = nn.ModuleList([SharedMLP(k, (64, 128, 1024)),
                                   SharedMLP(1024, (512, 256))])
        self.out = _ZeroInitDense(256, k * k)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        g = masked_max(self.mlps[0](x), mask, dim=1)          # (B, 1024)
        mat = self.out(self.mlps[1](g))
        eye = torch.eye(self.k, dtype=x.dtype, device=x.device).reshape(-1)
        return (mat + eye).view(-1, self.k, self.k)


class PointNetCls(nn.Module):
    """PointNet classification network. The T-Nets present are
    ``tnets`` in order (input, then feature), as flax numbers them.

    Dropout acts in ``train()`` mode only, its masks drawn from the
    ``generator`` the caller passes (the pipeline owns one, seeded from
    ``train.seed``)."""

    FLAX_KEYS = "pointnet_cls"  # its key map in ``weights.py``

    def __init__(self, num_classes: int = 40, use_input_tnet: bool = True,
                 use_feature_tnet: bool = True, dropout_rate: float = 0.4):
        super().__init__()
        self.use_input_tnet = use_input_tnet
        self.use_feature_tnet = use_feature_tnet
        self.tnets = nn.ModuleList(
            ([TNet(3)] if use_input_tnet else [])
            + ([TNet(64)] if use_feature_tnet else []))
        self.mlps = nn.ModuleList([SharedMLP(3, (64, 64)),
                                   SharedMLP(64, (64, 128, 1024))])
        self.head = MLPHead(1024, (512, 256), num_classes, dropout_rate)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator)

    def forward(self, points, point_mask,
                generator: Optional[torch.Generator] = None):
        """points (B, N, 3), point_mask (B, N) -> {'logits' (B, classes),
        'feature_transform' (B, 64, 64) or None}."""
        tnets = iter(self.tnets)
        x = points
        if self.use_input_tnet:
            x = torch.matmul(x, next(tnets)(x, point_mask))
        x = self.mlps[0](x)
        ft = None
        if self.use_feature_tnet:
            ft = next(tnets)(x, point_mask)
            x = torch.matmul(x, ft)
        g = masked_max(self.mlps[1](x), point_mask, dim=1)    # (B, 1024)
        return {"logits": self.head(g, generator), "feature_transform": ft}


def orthogonality_loss(transform: Optional[torch.Tensor]) -> torch.Tensor:
    """|| I - A A^T ||_F^2 averaged over the batch (under a data mesh,
    this rank's share of the global batch's mean); 0 without a
    transform."""
    if transform is None:
        return torch.tensor(0.0)
    k = transform.shape[-1]
    eye = torch.eye(k, dtype=transform.dtype, device=transform.device)
    diff = eye - torch.matmul(transform, transform.transpose(-1, -2))
    return mean_share((diff ** 2).sum(dim=(1, 2)))
