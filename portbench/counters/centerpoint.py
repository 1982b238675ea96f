"""CenterPoint's work at a batch's own inputs: forward FLOPs (each sparse
conv's from the reference's rulebook pairs at these clouds, the BEV
backbone's, neck's and centre head's from the configuration's widths),
the least time of the 21 ``spread_accumulate`` calls, and the voxels at
level 0 and those the level-0 budget cut.

``spread_bound_s`` follows ``chip_smoke.py::spread_bound`` with each
call's own tap count (27, or 3 for ``conv_out``): every target id, the
value rows that land and the f32 table written once, over the memory
rate.
"""

from __future__ import annotations

import copy
from typing import Dict, Tuple

import numpy as np
import torch

from portbench.harness.work import HBM_BYTES_PER_S, grid
from portbench.reference import centerpoint, second, wire


def dense_flops(cfg: Dict) -> float:
    """FLOPs (two a multiply-add) of one cloud's BEV backbone, neck and
    centre head, from the widths: 3x3 convs with ``SAME`` padding, the
    stride-1 up branch a 3x3 conv and a larger one a transposed conv with
    kernel = stride, as the program runs them."""
    p = cfg["model"]["params"]
    nx, ny, _ = grid(cfg)
    enc = centerpoint.sparse_shape(cfg)
    for k, s, pad in centerpoint.DOWN + (centerpoint.CONV_OUT,):
        enc = centerpoint.grid_out(enc, k, s, pad)
    cin = enc[0] * int(p.get("encoder_out_channels", 128))
    h, w = enc[1], enc[2]
    flops = 0.0
    head_hw = None
    for n, s, f, u, uf in zip(p["bev_layers"], p["bev_strides"],
                              p["bev_filters"], p["bev_up_strides"],
                              p["bev_up_filters"]):
        h, w = -(-h // s), -(-w // s)
        flops += 2.0 * 9 * cin * f * h * w + 2.0 * n * 9 * f * f * h * w
        flops += 2.0 * (9 if u == 1 else u * u) * f * uf * h * w
        head_hw = head_hw or h * w * (u * u if u > 1 else 1)
        cin = f
    c = int(p.get("head_channels", 64))
    flops += 2.0 * 9 * sum(p["bev_up_filters"]) * c * head_hw
    for task in p["tasks"]:
        outs = sum(width or len(task) for _, width in centerpoint.HEADS)
        flops += 2.0 * 9 * c * (len(centerpoint.HEADS) * c + outs) * head_hw
    return flops


def spread_bound_s(layers, value_bytes: int = 2) -> float:
    """Least seconds of one batch's ``spread_accumulate`` calls, one per
    sparse conv: (B, K, V_in) int32 targets with the call's own K, the
    ``value_bytes`` rows of the pairs that land, the (B, V_out, C) f32
    table."""
    total = 0.0
    for per_layer in zip(*layers):
        b = len(per_layer)
        _, _, _, _, cout, pad_in, pad_out, k = per_layer[0]
        pairs = sum(ly[2] for ly in per_layer)
        nbytes = (4 * b * k * pad_in + pairs * cout * value_bytes
                  + 4 * b * pad_out * cout)
        total += nbytes / HBM_BYTES_PER_S
    return total


def voxels(points: torch.Tensor, counts: np.ndarray, cfg: Dict
           ) -> Tuple[int, int]:
    """(voxels at level 0 after the budget, voxels the budget cut), summed
    over the clouds."""
    uncut = copy.deepcopy(cfg)
    uncut["budget"]["max_voxels"] = 1 << 40
    budget = int(cfg["budget"]["max_voxels"])
    kept = cut = 0
    for i in range(points.shape[0]):
        coords, _ = second.voxelize_mean(points[i, :int(counts[i])], uncut)
        kept += min(len(coords), budget)
        cut += max(len(coords) - budget, 0)
    return kept, cut


def count(cfg: Dict, points: np.ndarray, counts: np.ndarray, weights,
          device) -> Tuple[float, Dict[str, float]]:
    """(forward FLOPs, {"spread_bound_s": least seconds of the sparse
    convs' ``spread_accumulate`` calls, "voxels_level0", "voxels_cut"})
    of one batch of clouds (B, N, 5) with ``counts`` points, dequantized
    from the wire as the program sees them."""
    q, lo, scale = wire.pack_q16(points, counts)
    pts = wire.dequantize(q, lo, scale, device)
    with torch.no_grad():
        layers = centerpoint.layer_work(pts, torch.as_tensor(counts),
                                        weights, cfg)
    flops = sum(sum(2.0 * ly[2] * ly[3] * ly[4] for ly in one)
                for one in layers) + len(layers) * dense_flops(cfg)
    kept, cut = voxels(pts, counts, cfg)
    return flops, {"spread_bound_s": spread_bound_s(layers),
                   "voxels_level0": float(kept), "voxels_cut": float(cut)}
