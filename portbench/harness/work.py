"""The yardstick's shared arithmetic: the card's peaks, the voxel grid,
and the FLOPs of the BEV backbone, neck and anchor heads that the
detectors share, counted from a configuration's published widths. Each
configuration's own counter (``portbench/counters/<name>.py``) builds on
these.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple


# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def _same_out(n: int, s: int) -> int:
    return -(-n // s)


def grid(cfg: Dict) -> Tuple[int, int, int]:
    """(nx, ny, nz) of the voxel grid."""
    r = cfg["voxel"]["point_cloud_range"]
    vs = cfg["voxel"]["voxel_size"]
    return tuple(int(round((r[i + 3] - r[i]) / vs[i])) for i in range(3))


def bev_head_flops(cfg: Dict, in_channels: int, ny: int, nx: int,
                   layers: Sequence[int], strides: Sequence[int],
                   filters: Sequence[int], up_strides: Sequence[int],
                   up_filters: Sequence[int]) -> int:
    """FLOPs (two a multiply-add) of the BEV backbone, its upsampling
    neck and the 1x1 anchor heads on an (ny, nx) map."""
    flops, h, w, cin = 0, ny, nx, in_channels
    head_hw = None
    for n, s, f, u, uf in zip(layers, strides, filters, up_strides,
                              up_filters):
        h, w = _same_out(h, s), _same_out(w, s)
        flops += 2 * 9 * cin * f * h * w
        flops += 2 * n * 9 * f * f * h * w
        # Up branch: a 3x3 conv, or a transposed conv with kernel =
        # stride, which takes each input pixel through u * u taps.
        taps = 9 if u == 1 else u * u
        flops += 2 * taps * f * uf * h * w
        head_hw = head_hw or h * w * (u * u if u > 1 else 1)
        cin = f
    classes = len(cfg["data"]["class_names"])
    anchors = 2 * classes
    flops += 2 * sum(up_filters) * anchors * (classes + 7 + 2) * head_hw
    return flops
