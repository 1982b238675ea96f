"""PointNet++ part segmentation and classification (port of
``lisec_tpu/models/pointnet2.py``).

Set abstraction (farthest-point sampling -> ball query -> grouping ->
shared MLP -> max over the neighbours), twice; a global set abstraction;
for part segmentation, feature propagation (3-NN inverse-distance
interpolation + skip concat + shared MLP) back to the input points and a
per-point head with the category one-hot; for classification, an FC
head on the global feature. SSG by default, MSG (several radii per
level, concatenated) with ``msg=True``. Points, masks and features are
channels-last, as in the JAX package; the sampling and every gather run
the hand-written kernels on the card (``ops/cuda/fps.py``,
``ops/cuda/gather_rows.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from lisec_tpu_torch.models.common import (
    BatchNorm, Dense, MLPHead, SharedMLP, dropout, dropout_key, masked_max,
    reset_parameters)
from lisec_tpu_torch.ops.ball_query import ball_query
from lisec_tpu_torch.ops.cuda import fps as fps_kernel
from lisec_tpu_torch.ops.grouping import group_and_decorate
from lisec_tpu_torch.ops.three_nn import three_interpolate, three_nn


class SetAbstraction(nn.Module):
    """FPS -> ball query -> group + decorate -> shared MLP -> max, one
    (radius, K, MLP) per scale, the scales' features concatenated."""

    def __init__(self, in_features: int, num_samples: int,
                 radii: Sequence[float], num_neighbors: Sequence[int],
                 mlps: Sequence[Sequence[int]]):
        super().__init__()
        self.num_samples = num_samples
        self.radii = tuple(radii)
        self.num_neighbors = tuple(num_neighbors)
        self.mlps = nn.ModuleList(SharedMLP(3 + in_features, mlp)
                                  for mlp in mlps)
        self.out_features = sum(mlp[-1] for mlp in mlps)

    def forward(self, xyz, features, mask):
        """xyz (B, N, 3), features (B, N, C) or None, mask (B, N) ->
        (new_xyz (B, M, 3), new_features (B, M, C'), new_mask (B, M))."""
        # One launch on the card: the picks, their xyz and their mask.
        _, new_xyz, new_mask = fps_kernel.fps_gather(
            xyz.float().contiguous(), mask.bool().contiguous(),
            self.num_samples)
        outs = []
        for radius, k, mlp in zip(self.radii, self.num_neighbors, self.mlps):
            nbr = ball_query(new_xyz, xyz, mask, radius=radius,
                             num_neighbors=k)                 # (B, M, K)
            h = mlp(group_and_decorate(xyz, features, new_xyz, nbr))
            # The ball query's repeat-fill puts a real in-radius point in
            # every slot, so a plain max is right.
            outs.append(h.amax(dim=-2))
        return new_xyz, torch.cat(outs, dim=-1), new_mask


class GlobalSetAbstraction(nn.Module):
    """The group-all variant: one global feature per cloud."""

    def __init__(self, in_features: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp = SharedMLP(3 + in_features, mlp)

    def forward(self, xyz, features, mask):
        x = torch.cat([xyz, features], dim=-1)
        return masked_max(self.mlp(x), mask, dim=-2)           # (B, C')


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance upsampling + skip concat + shared MLP."""

    def __init__(self, in_features: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp = SharedMLP(in_features, mlp)

    def forward(self, xyz_target, xyz_source, feats_target, feats_source,
                source_mask):
        dist2, idx = three_nn(xyz_target, xyz_source, source_mask)
        interp = three_interpolate(feats_source, idx, dist2)
        return self.mlp(torch.cat([feats_target, interp], dim=-1))


class PointNet2PartSeg(nn.Module):
    """Part segmentation network (ShapeNetPart), SSG or MSG, on xyz
    points, as the ShapeNetPart loader gives them (the JAX network's
    extra point channels have no caller).

    Dropout (rate ``dropout_rate``, 0.4) acts in ``train()`` mode only,
    as flax's ``Dropout_0`` does, its mask drawn under the step key the
    caller passes (``models.common.dropout``)."""

    def __init__(self, num_parts: int = 50, num_categories: int = 16,
                 width: int = 1, msg: bool = False):
        super().__init__()
        w = width
        if msg:
            sa1 = SetAbstraction(
                0, 512, (0.1, 0.2, 0.4), (16, 32, 64),
                ((32 * w, 32 * w, 64 * w), (64 * w, 64 * w, 128 * w),
                 (64 * w, 96 * w, 128 * w)))
            sa2 = SetAbstraction(
                sa1.out_features, 128, (0.4, 0.8), (64, 128),
                ((128 * w, 128 * w, 256 * w), (128 * w, 196 * w, 256 * w)))
        else:
            sa1 = SetAbstraction(0, 512, (0.2,), (32,),
                                 ((64 * w, 64 * w, 128 * w),))
            sa2 = SetAbstraction(sa1.out_features, 128, (0.4,), (64,),
                                 ((128 * w, 128 * w, 256 * w),))
        self.sa = nn.ModuleList([sa1, sa2])
        c1, c2 = sa1.out_features, sa2.out_features
        self.global_sa = GlobalSetAbstraction(c2, (256 * w, 512 * w,
                                                   1024 * w))
        self.fp3 = SharedMLP(c2 + 1024 * w, (256 * w, 256 * w))
        self.fp = nn.ModuleList([
            FeaturePropagation(c1 + 256 * w, (256 * w, 128 * w)),
            FeaturePropagation(num_categories + 3 + 128 * w,
                               (128 * w, 128 * w, 128 * w))])
        self.head_dense = Dense(128 * w, 128 * w)
        self.head_bn = BatchNorm(128 * w)
        self.head_out = Dense(128 * w, num_parts)
        self.dropout_rate = 0.4

    def reset_parameters(self, seed: int) -> None:
        """The JAX package's initial weights from ``seed``
        (``models.common.reset_parameters``)."""
        reset_parameters(self, seed)

    def dropout(self, h: torch.Tensor, rng: Optional[np.ndarray]
                ) -> torch.Tensor:
        """flax's ``Dropout_0`` under the step key ``rng``, in
        ``train()`` mode only."""
        if not self.training:
            return h
        return dropout(h, self.dropout_rate, dropout_key(rng, ("Dropout_0",)))

    def forward(self, points, point_mask, category_onehot,
                rng: Optional[np.ndarray] = None):
        """points (B, N, 3), point_mask (B, N), category_onehot
        (B, num_categories) -> per-point logits (B, N, num_parts)."""
        xyz = points
        xyz1, f1, m1 = self.sa[0](xyz, None, point_mask)
        xyz2, f2, m2 = self.sa[1](xyz1, f1, m1)
        g = self.global_sa(xyz2, f2, m2)                       # (B, 1024 w)

        # FP3: the global feature broadcast back to the SA2 centres.
        gb = g[:, None, :].expand(*xyz2.shape[:-1], g.shape[-1])
        f2u = self.fp3(torch.cat([f2, gb], dim=-1))
        f1u = self.fp[0](xyz1, xyz2, f1, f2u, m2)

        # FP1's skip: the category one-hot and the raw points per point.
        cat = category_onehot[:, None, :].expand(
            *xyz.shape[:-1], category_onehot.shape[-1])
        f0 = self.fp[1](xyz, xyz1, torch.cat([cat, xyz], dim=-1), f1u, m1)

        h = torch.relu(self.head_bn(self.head_dense(f0)))
        return self.head_out(self.dropout(h, rng))


class PointNet2Cls(nn.Module):
    """SSG classification network (ModelNet40-style) on xyz points, as the
    ModelNet40 loader gives them: two set abstractions (512 centres,
    radius 0.2, 32 neighbours; 128, 0.4, 64), the global one, and the
    head Dense(512 w)-BN-ReLU-dropout, Dense(256 w)-BN-ReLU-dropout,
    Dense(classes), its hidden Dense layers with a bias as in the JAX
    network. Dropout (0.4) as in :class:`PointNet2PartSeg`, its layers
    flax's top-level ``Dropout_0`` and ``Dropout_1``."""

    FLAX_KEYS = "pointnet2_cls"  # its key map in ``weights.py``

    def __init__(self, num_classes: int = 40, width: int = 1):
        super().__init__()
        w = width
        sa1 = SetAbstraction(0, 512, (0.2,), (32,),
                             ((64 * w, 64 * w, 128 * w),))
        sa2 = SetAbstraction(sa1.out_features, 128, (0.4,), (64,),
                             ((128 * w, 128 * w, 256 * w),))
        self.sa = nn.ModuleList([sa1, sa2])
        self.global_sa = GlobalSetAbstraction(
            sa2.out_features, (256 * w, 512 * w, 1024 * w))
        self.head = MLPHead(1024 * w, (512 * w, 256 * w), num_classes,
                            dropout_rate=0.4, hidden_bias=True, flax_path=())

    def reset_parameters(self, seed: int) -> None:
        """The JAX package's initial weights from ``seed``
        (``models.common.reset_parameters``)."""
        reset_parameters(self, seed)

    def forward(self, points, point_mask, rng: Optional[np.ndarray] = None):
        """points (B, N, 3), point_mask (B, N) -> {'logits' (B, classes),
        'feature_transform': None}."""
        xyz1, f1, m1 = self.sa[0](points, None, point_mask)
        xyz2, f2, m2 = self.sa[1](xyz1, f1, m1)
        g = self.global_sa(xyz2, f2, m2)                       # (B, 1024 w)
        return {"logits": self.head(g, rng),
                "feature_transform": None}
