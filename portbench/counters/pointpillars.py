"""PointPillars' work at a batch's own inputs: forward FLOPs counted from
the configuration's published widths, and ``pillar_canvas_fused``'s least
time.

``encoder_bound`` is a frozen copy of ``chip_smoke.py::encoder_bound``:
each input read once and the canvas written once over the memory rate,
against its float32 operations over the float32 rate.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from portbench.harness.work import (
    HBM_BYTES_PER_S, PEAK_F32_FLOPS, bev_head_flops, grid)


def pointpillars_flops(cfg: Dict, valid_points: float = 0.0) -> float:
    """Forward FLOPs of one PointPillars cloud: the PFN's linear layer
    over its valid points, backbone, neck and head."""
    p = cfg["model"]["params"]
    nx, ny, _ = grid(cfg)
    c = int(p.get("pfn_filters", 64))
    return 2.0 * 9 * c * valid_points + bev_head_flops(
        cfg, c, ny, nx, p.get("backbone_layers", [3, 5, 5]),
        p.get("backbone_strides", [2, 2, 2]),
        p.get("backbone_filters", [64, 128, 256]),
        p.get("backbone_up_strides", [1, 2, 4]),
        p.get("backbone_up_filters", [128, 128, 128]))


def encoder_bound(pts_bytes: int, mask_bytes: int, w_bytes: int,
                  t_bytes: int, out_elems: int, out_bytes: int,
                  valid_points: int, nonempty_cells: int, channels: int):
    """Least seconds of ``pillar_canvas_fused``: (seconds, what bounds
    it, bytes)."""
    nbytes = (pts_bytes + mask_bytes + w_bytes + t_bytes
              + out_elems * out_bytes)
    ops = 8 * channels * valid_points + 10 * channels * nonempty_cells
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = ops / PEAK_F32_FLOPS
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), nbytes


def pillar_counts(points: np.ndarray, count: int, cfg: Dict
                  ) -> Tuple[int, int]:
    """(valid points, non-empty pillars) of one cloud: the points in
    range, and the distinct cells they fall in."""
    r = cfg["voxel"]["point_cloud_range"]
    vs = cfg["voxel"]["voxel_size"]
    nx, ny, _ = grid(cfg)
    p = points[:count]
    ix = np.floor((p[:, 0] - np.float32(r[0])) / np.float32(vs[0]))
    iy = np.floor((p[:, 1] - np.float32(r[1])) / np.float32(vs[1]))
    ok = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
          & (p[:, 2] >= r[2]) & (p[:, 2] < r[5]))
    cells = (iy[ok] * nx + ix[ok]).astype(np.int64)
    return int(ok.sum()), int(np.unique(cells).size)


def count(cfg: Dict, points: np.ndarray, counts: np.ndarray, weights,
          device) -> Tuple[float, Dict[str, float]]:
    """(forward FLOPs, {"encoder_bound_s": least seconds of the
    encoder}) of one batch of clouds (B, N, 4) with ``counts`` points."""
    b, n = points.shape[:2]
    vp, ne = zip(*(pillar_counts(points[i], int(counts[i]), cfg)
                   for i in range(b)))
    nx, ny, _ = grid(cfg)
    p = cfg["model"]["params"]
    c = int(p.get("pfn_filters", 64))
    out_bytes = 2 if p.get("dtype") == "bfloat16" else 4
    s, _, _ = encoder_bound(b * n * 16, b * n, 9 * c * 4, c * 4,
                            b * ny * nx * c, out_bytes, sum(vp), sum(ne), c)
    return (sum(pointpillars_flops(cfg, v) for v in vp),
            {"encoder_bound_s": s})
