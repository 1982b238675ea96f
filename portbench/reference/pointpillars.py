"""PointPillars inference in plain PyTorch, float32, for the reference.

Lang et al., "PointPillars: Fast Encoders for Object Detection from Point
Clouds", CVPR 2019: points decorated with their offsets from the
pillar's mean and centre, a linear layer + BatchNorm + ReLU, a max over
each pillar's points onto the BEV canvas; a three-block strided conv
backbone whose outputs are upsampled and concatenated; 1x1 anchor heads
for class, box residuals and direction.

The weights are a flat dict in the flax layout (``params/...`` and
``batch_stats/...``, kernels (kh, kw, in, out)), as the snapshot file and
the benchmark's seed draw give them. Nothing here uses the port.
``lowp`` is a cast applied to every operand of a linear layer or conv
(identity for the reference; the control passes a lower precision).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
# A calibrated BatchNorm maps this quantile of |x - mean| to this many
# units (``_bn``).
CALIBRATE_QUANTILE = 0.99
CALIBRATE_SPREAD = 2.5
Cast = Callable[[torch.Tensor], torch.Tensor]


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _bn(x: torch.Tensor, w: Dict, name: str, dim: int,
        calibrate: bool = False, mask: torch.Tensor = None) -> torch.Tensor:
    """BatchNorm with the running statistics in ``w``; with
    ``calibrate`` those are first set to this input's statistics over its
    rows that hold a non-zero value (and where ``mask``, if given), as a
    seed draw's weights want."""
    shape = [1] * x.dim()
    shape[dim] = -1
    if calibrate:
        rows = x.movedim(dim, -1).reshape(-1, x.shape[dim])
        keep = (rows != 0).any(1)
        if mask is not None:
            keep &= mask.movedim(dim, -1).reshape(-1, x.shape[dim])[:, 0]
        rows = rows[keep]
        if rows.shape[0] > 1 << 16:
            rows = rows[torch.linspace(0, rows.shape[0] - 1, 1 << 16,
                                       device=rows.device).long()]
        mean = rows.mean(0)
        # The spread by a high quantile, not the variance: the occupied
        # cells' heavy tail would otherwise grow layer after layer.
        q = torch.quantile((rows - mean).abs(), CALIBRATE_QUANTILE, dim=0)
        w[f"batch_stats/{name}/mean"] = mean
        w[f"batch_stats/{name}/var"] = (q / CALIBRATE_SPREAD) ** 2
    mean = w[f"batch_stats/{name}/mean"].view(shape)
    var = w[f"batch_stats/{name}/var"].view(shape)
    scale = w[f"params/{name}/scale"].view(shape)
    bias = w[f"params/{name}/bias"].view(shape)
    return (x - mean) * torch.rsqrt(var + BN_EPS) * scale + bias


def _pad_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def conv_bn_relu(x: torch.Tensor, w: Dict, name: str, stride: int,
                 lowp: Cast, calibrate: bool = False) -> torch.Tensor:
    """flax Conv (SAME) or ConvTranspose (kernel = stride) + BN + ReLU."""
    conv = f"params/{name}/Conv_0/kernel"
    if conv in w:
        k = w[conv]                                   # (kh, kw, in, out)
        x = F.conv2d(_pad_same(lowp(x), k.shape[0], stride),
                     lowp(k.permute(3, 2, 0, 1)), stride=stride)
    else:
        k = w[f"params/{name}/ConvTranspose_0/kernel"]
        if k.shape[0] != stride:
            raise ValueError("only kernel = stride transposed convs")
        # flax's transposed conv correlates the dilated input with the
        # kernel as stored: output pixel y * s + i takes tap s - 1 - i.
        x = F.conv_transpose2d(lowp(x), lowp(k.permute(2, 3, 0, 1)
                                             .flip(2, 3)), stride=stride)
    return torch.relu(_bn(x, w, f"{name}/BatchNorm_0", 1, calibrate))


def backbone(x: torch.Tensor, w: Dict, layer_nums: Sequence[int],
             strides: Sequence[int], up_strides: Sequence[int],
             lowp: Cast, prefix: str = "BEVBackbone_0",
             calibrate: bool = False) -> torch.Tensor:
    ups, i = [], 0
    for n, s, u in zip(layer_nums, strides, up_strides):
        x = conv_bn_relu(x, w, f"{prefix}/ConvBNRelu_{i}", s, lowp,
                         calibrate)
        for j in range(n):
            x = conv_bn_relu(x, w, f"{prefix}/ConvBNRelu_{i + 1 + j}", 1,
                             lowp, calibrate)
        ups.append(conv_bn_relu(x, w, f"{prefix}/ConvBNRelu_{i + n + 1}",
                                u, lowp, calibrate))
        i += n + 2
    return torch.cat(ups, 1)


def head(x: torch.Tensor, w: Dict, num_classes: int, lowp: Cast,
         prefix: str = "AnchorHead_0") -> Dict[str, torch.Tensor]:
    """(B, C, H, W) -> class logits (B, A, classes), residuals (B, A, 7),
    direction logits (B, A, 2), anchors in (y, x, anchor) order."""
    b = x.shape[0]
    out = {}
    for i, (key, k) in enumerate((("cls", num_classes), ("box", 7),
                                  ("dir", 2))):
        kern = w[f"params/{prefix}/Conv_{i}/kernel"][0, 0]   # (in, out)
        bias = w[f"params/{prefix}/Conv_{i}/bias"]
        y = torch.einsum("bchw,co->bhwo", lowp(x), lowp(kern)) + bias
        out[key] = y.reshape(b, -1, k)
    return out


def pillar_canvas(points: torch.Tensor, counts: torch.Tensor, w: Dict,
                  cfg: Dict, lowp: Cast) -> torch.Tensor:
    """(B, N, 4) points with ``counts`` valid rows -> (B, C, ny, nx)."""
    r = cfg["voxel"]["point_cloud_range"]
    vs = cfg["voxel"]["voxel_size"]
    nx = int(round((r[3] - r[0]) / vs[0]))
    ny = int(round((r[4] - r[1]) / vs[1]))
    b, n, _ = points.shape
    kern = w["params/FusedPillarEncoder_0/kernel"]            # (9, C)
    c = kern.shape[1]
    canvas = torch.zeros((b, ny * nx, c), device=points.device)
    inv = [torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
        v, dtype=torch.float32) for v in vs[:2]]
    for i in range(b):
        p = points[i, :int(counts[i])]
        # The cell of a point: floor((x - x0) * (1 / size)) in float32,
        # the multiply by the reciprocal that the configuration's jitted
        # reference program makes of the division.
        ix = torch.floor((p[:, 0] - r[0]) * inv[0].item()).long()
        iy = torch.floor((p[:, 1] - r[1]) * inv[1].item()).long()
        ok = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
              & (p[:, 2] >= r[2]) & (p[:, 2] < r[5]))
        p, ix, iy = p[ok], ix[ok], iy[ok]
        cell = iy * nx + ix
        sums = torch.zeros((ny * nx, 3), dtype=torch.float64,
                           device=p.device).index_add_(0, cell,
                                                       p[:, :3].double())
        cnt = torch.zeros((ny * nx,), dtype=torch.float64,
                          device=p.device).index_add_(
            0, cell, torch.ones_like(cell, dtype=torch.float64))
        mean = (sums / cnt.clamp_min(1)[:, None]).float()[cell]
        cx = (ix.float() + 0.5) * vs[0] + r[0]
        cy = (iy.float() + 0.5) * vs[1] + r[1]
        feats = torch.cat([p, p[:, :3] - mean,
                           torch.stack([p[:, 0] - cx, p[:, 1] - cy], 1)], 1)
        h = lowp(feats) @ lowp(kern)
        h = torch.relu(_bn(h, w, "FusedPillarEncoder_0", 1))
        canvas[i].scatter_reduce_(0, cell[:, None].expand(-1, c), h,
                                  "amax", include_self=True)
    return canvas.view(b, ny, nx, c).permute(0, 3, 1, 2)


def forward(points: torch.Tensor, counts: torch.Tensor, w: Dict,
            cfg: Dict, lowp: Cast = _same) -> Dict[str, torch.Tensor]:
    """Per-anchor logits and residuals of a batch of clouds."""
    p = cfg["model"]["params"]
    x = pillar_canvas(points, counts, w, cfg, lowp)
    x = backbone(x, w, p.get("backbone_layers", [3, 5, 5]),
                 p.get("backbone_strides", [2, 2, 2]),
                 p.get("backbone_up_strides", [1, 2, 4]), lowp)
    return head(x, w, len(cfg["data"]["class_names"]), lowp)


def output_stride(cfg: Dict) -> int:
    return 2
