"""Ray-cast 10-sweep lidar frames in the manner of nuScenes: a 32-beam
spinning sensor (HDL-32E: elevations +10.67 to -30.67 degrees, 360
degrees in 1,085 azimuth steps, 70 m reach) on an ego vehicle driving
along +x, swept 10 times 0.05 s apart, each sweep carried into the
keyframe's frame with its time lag as a fifth channel, as nuScenes'
multi-sweep frames are.

A scene holds cars, trucks, construction vehicles, buses, trailers,
pedestrians, cyclists and motorcyclists, barriers and traffic cones
(nuScenes' mean sizes) over the +-54 m square, the vehicles and people
moving along their headings, and unlabelled buildings along both sides
of the road and poles, which the upward beams hit. The nearest hit wins
(occlusion); range noise and 5% dropout as ``raycast_hard.py`` has them,
whose ray-box test this reuses. Points are (x, y, z, intensity 0-255,
time lag s), the keyframe's sweep first.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from portbench.traffic.raycast_hard import _ray_box_t

BEAMS = 32
ELEVATION_DEG = (10.67, -30.67)
AZIMUTH_STEPS = 1085
SWEEPS = 10
SWEEP_DT = 0.05
REACH_M = 70.0
SENSOR_Z = 1.84             # above the ground; the frame's z = 0 is the sensor
# class: ((l, w, h), count range, speed range m/s, share that moves)
CLASSES = {
    "car": ((4.63, 1.97, 1.74), (18, 34), (2.0, 14.0), 0.6),
    "truck": ((6.93, 2.51, 2.84), (2, 6), (2.0, 10.0), 0.4),
    "construction_vehicle": ((6.37, 2.85, 3.19), (0, 2), (0.5, 2.0), 0.2),
    "bus": ((10.5, 2.94, 3.47), (0, 3), (2.0, 9.0), 0.5),
    "trailer": ((12.29, 2.90, 3.87), (0, 2), (2.0, 8.0), 0.3),
    "barrier": ((0.50, 2.53, 0.98), (6, 16), (0.0, 0.0), 0.0),
    "motorcycle": ((2.11, 0.77, 1.47), (1, 4), (2.0, 10.0), 0.6),
    "bicycle": ((1.70, 0.60, 1.28), (1, 5), (2.0, 6.0), 0.6),
    "pedestrian": ((0.73, 0.67, 1.77), (8, 24), (0.6, 1.8), 0.7),
    "traffic_cone": ((0.41, 0.41, 1.07), (3, 12), (0.0, 0.0), 0.0),
}
HALF_EXTENT = 54.0


def _rays() -> np.ndarray:
    """(R, 3) unit directions, beam-major."""
    elev = np.deg2rad(np.linspace(*ELEVATION_DEG, BEAMS))
    azim = np.linspace(-np.pi, np.pi, AZIMUTH_STEPS, endpoint=False)
    ee, aa = np.meshgrid(elev, azim, indexing="ij")
    ce = np.cos(ee).ravel()
    d = np.stack([ce * np.cos(aa).ravel(), ce * np.sin(aa).ravel(),
                  np.sin(ee).ravel()], axis=-1)
    return d


_D = _rays()
_STEP = 2 * np.pi / AZIMUTH_STEPS


def _columns(rel: np.ndarray, radius: float) -> np.ndarray:
    """The azimuth columns whose rays can meet a body of bounding
    ``radius`` at ``rel`` (centre less the sensor)."""
    dist = float(np.hypot(rel[0], rel[1]))
    if dist <= radius + 0.5:
        return np.arange(AZIMUTH_STEPS)
    half = np.arcsin(min(radius / dist, 1.0)) + _STEP
    az = np.arctan2(rel[1], rel[0])
    lo = int(np.floor((az - half + np.pi) / _STEP))
    hi = int(np.ceil((az + half + np.pi) / _STEP))
    return np.arange(lo, hi + 1) % AZIMUTH_STEPS


def _scene(rng):
    """Bodies: (centre (3,) at the keyframe, half extents (3,), yaw,
    velocity (2,), intensity range) in the keyframe's frame."""
    ground = -SENSOR_Z
    bodies = []
    for size, (n0, n1), (v0, v1), moving in CLASSES.values():
        l, w, h = size
        for _ in range(int(rng.integers(n0, n1 + 1))):
            while True:
                x, y = rng.uniform(-HALF_EXTENT, HALF_EXTENT, 2)
                if np.hypot(x, y) > 4.0 + l / 2:
                    break
            yaw = rng.uniform(-np.pi, np.pi)
            s = l * rng.uniform(0.9, 1.1)
            size_j = (s, w * rng.uniform(0.9, 1.1), h * rng.uniform(0.9, 1.1))
            speed = rng.uniform(v0, v1) if rng.random() < moving else 0.0
            vel = speed * np.array([np.cos(yaw), np.sin(yaw)])
            bodies.append((np.array([x, y, ground + size_j[2] / 2]),
                           np.array(size_j) / 2, yaw, vel, (10.0, 90.0)))
    # Buildings along both sides of the road and poles: static.
    for side in (-1.0, 1.0):
        x = -HALF_EXTENT - 10.0
        while x < HALF_EXTENT + 10.0:
            length = rng.uniform(8.0, 30.0)
            gap = rng.uniform(2.0, 12.0)
            depth = rng.uniform(6.0, 14.0)
            off = rng.uniform(11.0, 26.0)
            height = rng.uniform(4.0, 16.0)
            bodies.append((np.array([x + length / 2, side * (off + depth / 2),
                                     ground + height / 2]),
                           np.array([length / 2, depth / 2, height / 2]),
                           rng.uniform(-0.05, 0.05), np.zeros(2),
                           (20.0, 120.0)))
            x += length + gap
    for _ in range(int(rng.integers(10, 24))):
        x = rng.uniform(-HALF_EXTENT, HALF_EXTENT)
        y = rng.choice([-1.0, 1.0]) * rng.uniform(7.0, 11.0)
        h = rng.uniform(3.0, 8.0)
        r = rng.uniform(0.1, 0.4)
        bodies.append((np.array([x, y, ground + h / 2]),
                       np.array([r, r, h / 2]), 0.0, np.zeros(2),
                       (30.0, 150.0)))
    return bodies


def _sweep(rng, bodies, origin: np.ndarray, lag: float) -> np.ndarray:
    """One sweep's points (n, 5) from ``origin``, the bodies where they
    were ``lag`` seconds before the keyframe."""
    d = _D
    tz = np.where(d[:, 2] < -1e-6, -SENSOR_Z / np.minimum(d[:, 2], -1e-6),
                  np.inf)
    best = np.where(tz <= REACH_M, tz, np.inf)
    inten = np.full(d.shape[0], -1.0)
    beams = np.arange(BEAMS)[:, None] * AZIMUTH_STEPS
    for c0, half, yaw, vel, (i0, i1) in bodies:
        c = c0.copy()
        c[:2] -= vel * lag
        rel = c - origin
        if np.hypot(rel[0], rel[1]) - np.hypot(half[0], half[1]) > REACH_M:
            continue
        cols = _columns(rel, float(np.hypot(half[0], half[1])))
        sub = (beams + cols[None, :]).ravel()
        cc, ss = np.cos(yaw), np.sin(yaw)
        rot = np.array([[cc, ss, 0.0], [-ss, cc, 0.0], [0.0, 0.0, 1.0]])
        t = _ray_box_t(rot @ (origin - c), d[sub] @ rot.T, half)
        take = t < np.minimum(best[sub], REACH_M)
        best[sub[take]] = t[take]
        inten[sub[take]] = rng.uniform(i0, i1)
    keep = np.isfinite(best) & (rng.random(d.shape[0]) > 0.05)
    t = best[keep] * (1.0 + rng.normal(0.0, 0.002, int(keep.sum())))
    pts = origin[None, :] + d[keep] * t[:, None]
    ground = inten[keep] < 0
    i = np.where(ground, rng.uniform(1.0, 25.0, ground.shape), inten[keep])
    return np.concatenate([pts, i[:, None], np.full((len(t), 1), lag)], 1)


def make_nusc10_scene(seed: int, *, pc_range) -> Dict[str, np.ndarray]:
    """One 10-sweep frame: ``points`` (N, 5) float32 inside ``pc_range``,
    the keyframe's sweep first, and the labelled bodies' ``gt_boxes``
    (x, y, z, l, w, h, yaw, vx, vy) at the keyframe."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 10]))
    speed = rng.uniform(8.0, 12.0)
    bodies = _scene(rng)
    sweeps = []
    for k in range(SWEEPS):
        lag = k * SWEEP_DT
        origin = np.array([-speed * lag, 0.0, 0.0])
        sweeps.append(_sweep(rng, bodies, origin, lag))
    points = np.concatenate(sweeps).astype(np.float32)
    r = pc_range
    m = ((points[:, 0] >= r[0]) & (points[:, 0] < r[3])
         & (points[:, 1] >= r[1]) & (points[:, 1] < r[4])
         & (points[:, 2] >= r[2]) & (points[:, 2] < r[5]))
    labelled = [bd for bd in bodies if bd[4] == (10.0, 90.0)]
    boxes = np.asarray([[*c, *(2 * h), y, *v] for c, h, y, v, _ in labelled],
                       np.float32).reshape(-1, 9)
    return {"points": points[m], "gt_boxes": boxes}


def make_scene(seed: int, pc_range) -> Dict[str, np.ndarray]:
    """The entry that a traffic mix reaches by naming this file in its
    ``scenes``."""
    return make_nusc10_scene(seed, pc_range=pc_range)
