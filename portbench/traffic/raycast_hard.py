"""Ray-cast lidar scenes: a frozen copy of ``_ray_box_t`` and
``make_detection_scene_hard`` from the port's ``data/fixtures.py``.

The copy is the benchmark's: the program may change its fixtures, the
traffic that measures it does not change with them. A 64-beam spinning
lidar (front 90 degrees) is ray-cast against the ground, two-box car
bodies and unlabelled distractors, with occlusion, range falloff, range
noise and 5% dropout: about 20,700 points a scene.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _ray_box_t(o_loc: np.ndarray, d_loc: np.ndarray,
               half: np.ndarray) -> np.ndarray:
    """Slab-test entry distance of rays (origin ``o_loc`` (3,), dirs
    ``d_loc`` (R, 3), both already in the box frame) against an
    axis-aligned box with half-extents ``half`` (3,). Returns t (R,),
    +inf where the ray misses (or the hit is behind the origin)."""
    eps = 1e-9
    d = np.where(np.abs(d_loc) < eps, eps, d_loc)
    t1 = (-half[None, :] - o_loc[None, :]) / d
    t2 = (half[None, :] - o_loc[None, :]) / d
    tmin = np.minimum(t1, t2).max(axis=1)
    tmax = np.maximum(t1, t2).min(axis=1)
    hit = (tmax >= tmin) & (tmax > 0)
    t = np.where(tmin > 0, tmin, tmax)
    return np.where(hit, t, np.inf)


def make_detection_scene_hard(
    seed: int,
    *,
    num_objects: int = 8,
    num_distractors: int = 6,
    beams: int = 64,
    azimuth_steps: int = 384,
    pc_range=(0.0, -39.68, -3.0, 69.12, 39.68, 1.0),
    num_classes: int = 1,
) -> Dict[str, np.ndarray]:
    """Ray-cast lidar fixture: occlusion, truncation, ring-structured
    density falloff, distractor geometry, per-gt difficulty.

    The standard fixture (``make_detection_scene``) fills every box with
    a uniform point cloud, so a detector saturates it (rehearsal AP
    99.9, difficulty buckets degenerate — VERDICT r4 weak #3). This one
    simulates the sensor instead: a 64-beam spinning lidar (elevations
    +2 deg .. -24.8 deg, front-90-degree FOV) ray-cast against the
    ground plane, car bodies (two-box union: low hood + rear cabin, so
    heading stays learnable from visible geometry), and unlabeled
    distractors (walls / poles / bushes). Nearest hit wins, so closer
    geometry OCCLUDES; rings diverge with range, so density falls off
    like a real scan; boxes straddling the FOV or range boundary are
    TRUNCATED. Each gt gets occlusion (1 - visible/potential rays),
    truncation (fraction of footprint samples outside FOV/range), and a
    KITTI-threshold difficulty using the projected box height at a
    700 px focal length — near-clean gts are easy(0), distant/partially
    occluded moderate(1), heavily occluded/truncated hard(2), and gts
    with < 5 visible points are -1 (ignored by the AP evaluator, the
    devkit's DontCare semantics).
    """
    rng = np.random.default_rng(seed * 40093 + 17)
    fov = (-0.25 * np.pi, 0.25 * np.pi)
    ground_z = -1.73
    sensor_z = 0.0
    focal = 700.0

    # ---- scene geometry: gt objects (possibly multi-part) + distractors
    dims_by_class = [(3.9, 1.6, 1.56), (0.8, 0.6, 1.73), (1.76, 0.6, 1.73)]
    boxes, classes = [], []
    # parts: list of (center(3,), half(3,), yaw, owner) — owner = gt
    # index or -1 for unlabeled geometry.
    parts = []
    for i in range(num_objects):
        cls = int(rng.integers(0, num_classes))
        l, w, h = dims_by_class[cls % 3]
        r = rng.uniform(6.0, 66.0)
        az = rng.uniform(fov[0] * 1.05, fov[1] * 1.05)  # some truncate
        cx, cy = r * np.cos(az), r * np.sin(az)
        cz = ground_z + h / 2
        yaw = rng.uniform(-np.pi, np.pi)
        boxes.append([cx, cy, cz, l, w, h, yaw])
        classes.append(cls)
        if cls % 3 == 0:
            # Car = low full-length body + rear cabin (heading cue is
            # the same cabin-height asymmetry the uniform fixture used,
            # but here it is visible-surface geometry).
            body_h = 0.55 * h
            parts.append((np.array([cx, cy, ground_z + body_h / 2]),
                          np.array([l / 2, w / 2, body_h / 2]), yaw, i))
            cab_l = 5 * l / 8
            off = -3 * l / 16            # cabin spans [-l/2, l/8]
            cc, ss = np.cos(yaw), np.sin(yaw)
            parts.append((np.array([cx + off * cc, cy + off * ss,
                                    ground_z + h / 2]),
                          np.array([cab_l / 2, 0.45 * w, h / 2]), yaw, i))
        else:
            parts.append((np.array([cx, cy, cz]),
                          np.array([l / 2, w / 2, h / 2]), yaw, i))
    for _ in range(num_distractors):
        kind = int(rng.integers(0, 3))
        if kind == 0:      # wall
            l, w, h = rng.uniform(4, 12), 0.25, rng.uniform(1.0, 2.5)
        elif kind == 1:    # pole
            l, w, h = 0.3, 0.3, rng.uniform(2.0, 5.0)
        else:              # bush
            l, w, h = rng.uniform(1, 2.2), rng.uniform(1, 2.2), \
                rng.uniform(0.8, 1.5)
        r = rng.uniform(4.0, 66.0)
        az = rng.uniform(fov[0], fov[1])
        cx, cy = r * np.cos(az), r * np.sin(az)
        yaw = rng.uniform(-np.pi, np.pi)
        parts.append((np.array([cx, cy, ground_z + h / 2]),
                      np.array([l / 2, w / 2, h / 2]), yaw, -1))

    # ---- rays: beams x azimuth columns
    elev = np.deg2rad(np.linspace(2.0, -24.8, beams))
    azim = np.linspace(fov[0], fov[1], azimuth_steps, endpoint=False)
    ee, aa = np.meshgrid(elev, azim, indexing="ij")
    ce = np.cos(ee).ravel()
    d = np.stack([ce * np.cos(aa).ravel(), ce * np.sin(aa).ravel(),
                  np.sin(ee).ravel()], axis=-1)          # (R, 3)
    R = d.shape[0]
    o = np.array([0.0, 0.0, sensor_z])

    # Ground plane hit (z = ground_z), only for downward rays.
    tz = np.where(d[:, 2] < -1e-6,
                  (ground_z - sensor_z) / np.minimum(d[:, 2], -1e-6),
                  np.inf)
    best_t = np.where(tz <= 76.0, tz, np.inf)
    best_owner = np.where(np.isfinite(best_t), -2, -3)   # -2 ground
    potential = np.zeros((num_objects,), np.int64)
    part_t = np.full((len(parts), R), np.inf, np.float32)
    for j, (c, half, yaw, owner) in enumerate(parts):
        cc, ss = np.cos(yaw), np.sin(yaw)
        rot = np.array([[cc, ss, 0], [-ss, cc, 0], [0, 0, 1.0]])
        t = _ray_box_t(rot @ (o - c), d @ rot.T, half)
        part_t[j] = t
        take = t < best_t
        best_t = np.where(take, t, best_t)
        best_owner = np.where(take, owner, best_owner)
    for i in range(num_objects):
        own = [j for j, p in enumerate(parts) if p[3] == i]
        potential[i] = int(np.isfinite(part_t[own]).any(axis=0).sum())
    visible = np.bincount(
        np.maximum(best_owner, 0),
        weights=np.isfinite(best_t) & (best_owner >= 0),
        minlength=num_objects)[:num_objects]

    hit = np.isfinite(best_t)
    # Range noise + 5% dropout (real returns are lossy).
    keep = hit & (rng.random(R) > 0.05)
    t = best_t[keep] * (1.0 + rng.normal(0, 0.002, keep.sum()))
    pts = o[None, :] + d[keep] * t[:, None]
    owner = best_owner[keep]
    inten = np.where(owner == -2, rng.uniform(0.05, 0.3, owner.shape),
                     np.where(owner >= 0,
                              rng.uniform(0.4, 0.9, owner.shape),
                              rng.uniform(0.2, 0.6, owner.shape)))
    points = np.concatenate(
        [pts, inten[:, None]], axis=-1).astype(np.float32)
    m = ((points[:, 0] >= pc_range[0]) & (points[:, 0] < pc_range[3])
         & (points[:, 1] >= pc_range[1]) & (points[:, 1] < pc_range[4])
         & (points[:, 2] >= pc_range[2]) & (points[:, 2] < pc_range[5]))
    points = points[m]

    # ---- per-gt occlusion / truncation / difficulty
    difficulty = np.zeros((num_objects,), np.int32)
    for i, (bx, cls) in enumerate(zip(boxes, classes)):
        cx, cy, cz, l, w, h, yaw = bx
        occ = 1.0 - (visible[i] / potential[i] if potential[i] else 0.0)
        # Truncation: footprint corner samples outside FOV/range.
        gx = np.linspace(-l / 2, l / 2, 8)
        gy = np.linspace(-w / 2, w / 2, 4)
        mx, my = np.meshgrid(gx, gy)
        cc, ss = np.cos(yaw), np.sin(yaw)
        sx = cx + mx.ravel() * cc - my.ravel() * ss
        sy = cy + mx.ravel() * ss + my.ravel() * cc
        saz = np.arctan2(sy, sx)
        inside = ((sx >= pc_range[0]) & (sx < pc_range[3])
                  & (sy >= pc_range[1]) & (sy < pc_range[4])
                  & (saz >= fov[0]) & (saz <= fov[1]))
        trunc = 1.0 - inside.mean()
        depth = max(np.hypot(cx, cy), 1.0)
        h_px = focal * h / depth
        if visible[i] < 5:
            difficulty[i] = -1
        elif h_px >= 40 and occ <= 0.10 and trunc <= 0.15:
            difficulty[i] = 0
        elif h_px >= 25 and occ <= 0.40 and trunc <= 0.30:
            difficulty[i] = 1
        elif h_px >= 20 and occ <= 0.80 and trunc <= 0.50:
            difficulty[i] = 2
        else:
            difficulty[i] = -1
    return {
        "points": points,
        "gt_boxes": np.asarray(boxes, np.float32),
        "gt_classes": np.asarray(classes, np.int32),
        "difficulty": difficulty,
    }


def make_scene(seed: int, pc_range) -> Dict[str, np.ndarray]:
    """The entry that a traffic mix reaches by naming this file in its
    ``scenes``."""
    return make_detection_scene_hard(seed, pc_range=pc_range)
