"""SECOND's work at a batch's own inputs: forward FLOPs (each sparse conv's
from the reference's rulebook pairs at these clouds, the dense tail's
and the BEV head's from the configuration's published widths), and the
least time of ``spread_accumulate``'s calls.

``spread_bound_s`` follows ``chip_smoke.py::spread_bound``: every target
id, the value rows that land and the f32 table written once, over the
memory rate.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from portbench.harness.work import HBM_BYTES_PER_S, bev_head_flops, grid
from portbench.reference import second, wire


def second_flops(cfg: Dict, layers) -> float:
    """Forward FLOPs of one SECOND cloud: each sparse conv's pairs (from
    the reference's rulebooks at this cloud, ``second.layer_work``), the
    dense tail's 3^3 convs over its whole grid, the BEV backbone, neck and
    head."""
    p = cfg["model"]["params"]
    nx, ny, nz = grid(cfg)
    chans = p.get("encoder_channels", [16, 32, 64, 64])
    n_levels = len(chans)
    dense_from = min(max(int(p.get("dense_from_level", 2)), 1), n_levels)
    flops = sum(2.0 * pairs * cin * cout
                for _, _, pairs, cin, cout, _, _ in layers)
    for _ in range(n_levels - 1):
        nx, ny, nz = (-(-nx // 2), -(-ny // 2), -(-nz // 2))
    c = chans[-1]
    flops += 2 * (n_levels - dense_from) * 2.0 * 27 * c * c * nx * ny * nz
    return flops + bev_head_flops(
        cfg, nz * c, ny, nx, p.get("bev_layers", [5, 5]),
        p.get("bev_strides", [1, 2]), p.get("bev_filters", [128, 256]),
        p.get("bev_up_strides", [1, 2]), p.get("bev_up_filters", [256, 256]))


def spread_bound_s(layers, value_bytes: int = 2) -> float:
    """Least seconds of one batch's ``spread_accumulate`` calls, one per
    sparse conv: (B, 27, V_in) int32 targets, the ``value_bytes`` rows of
    the pairs that land, the (B, V_out, C) f32 table."""
    total = 0.0
    for per_layer in zip(*layers):
        b = len(per_layer)
        _, _, _, _, cout, pad_in, pad_out = per_layer[0]
        pairs = sum(ly[2] for ly in per_layer)
        nbytes = (4 * b * 27 * pad_in + pairs * cout * value_bytes
                  + 4 * b * pad_out * cout)
        total += nbytes / HBM_BYTES_PER_S
    return total


def count(cfg: Dict, points: np.ndarray, counts: np.ndarray, weights,
          device) -> Tuple[float, Dict[str, float]]:
    """(forward FLOPs, {"spread_bound_s": least seconds of the sparse
    convs' ``spread_accumulate`` calls}) of one batch of clouds (B, N, 4)
    with ``counts`` points, dequantized from the wire as the program
    sees them."""
    q, lo, scale = wire.pack_q16(points, counts)
    layers = second.layer_work(wire.dequantize(q, lo, scale, device),
                               torch.as_tensor(counts), weights, cfg)
    return (sum(second_flops(cfg, ly) for ly in layers),
            {"spread_bound_s": spread_bound_s(layers)})
