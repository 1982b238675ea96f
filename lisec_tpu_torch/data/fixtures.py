"""Synthetic fixtures (copy of ``_unit_shape``, ``make_cls_cloud``,
``make_partseg_cloud``, ``make_detection_scene``, ``_ray_box_t``,
``make_detection_scene_hard``, ``make_semantic_scene`` and the writers
``write_kitti_fixture``, ``write_semantickitti_fixture`` and
``write_modelnet_fixture`` from ``lisec_tpu/data/fixtures.py``).

Real datasets are not shipped, so training, the smoke run and the tests
draw data from a seed: class-conditioned and part-labelled shapes in the
unit sphere, lidar-like scenes of box-shaped clusters on ground clutter
or ray-cast scenes with occlusion, and semantically labelled scans; the
writers put them on disk in the KITTI, SemanticKITTI and ModelNet40
layouts for the file loaders. The copy must reproduce the JAX package's
arrays and files bit for bit
(``tests/test_torch_pointpillars.py``, ``tests/test_torch_partseg.py``,
``tests/test_torch_rangeseg.py``, ``tests/test_torch_cls.py``).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np


def _unit_shape(rng: np.random.Generator, cls: int, n: int) -> np.ndarray:
    """A learnable class-conditioned point shape in the unit sphere."""
    kind = cls % 4
    if kind == 0:        # sphere shell, radius varies with class
        r = 0.4 + 0.55 * ((cls // 4) % 5) / 5.0
        v = rng.normal(size=(n, 3))
        v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-6)
        return (v * r).astype(np.float32)
    if kind == 1:        # cube surface, size varies
        s = 0.3 + 0.6 * ((cls // 4) % 5) / 5.0
        p = rng.uniform(-s, s, size=(n, 3)).astype(np.float32)
        ax = rng.integers(0, 3, n)
        sign = rng.choice([-1.0, 1.0], n)
        p[np.arange(n), ax] = s * sign
        return p
    if kind == 2:        # cylinder, aspect varies
        h = 0.3 + 0.6 * ((cls // 4) % 5) / 5.0
        theta = rng.uniform(0, 2 * np.pi, n)
        z = rng.uniform(-h, h, n)
        return np.stack([0.5 * np.cos(theta), 0.5 * np.sin(theta), z],
                        -1).astype(np.float32)
    # two clusters, separation varies
    d = 0.3 + 0.5 * ((cls // 4) % 5) / 5.0
    c = rng.choice([-d, d], n)
    return (rng.normal(scale=0.15, size=(n, 3)).astype(np.float32)
            + np.stack([c, np.zeros(n), np.zeros(n)], -1).astype(np.float32))


def make_cls_cloud(seed: int, cls: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed * 1009 + cls)
    return _unit_shape(rng, cls, n)


def make_partseg_cloud(
    seed: int, category: int, n: int, num_parts_per_cat: int = 3,
) -> Tuple[np.ndarray, np.ndarray]:
    """Cloud + per-point part labels: parts are spatial slabs along an
    axis that depends on the category (learnable from geometry)."""
    rng = np.random.default_rng(seed * 2003 + category)
    pts = _unit_shape(rng, category, n)
    axis = category % 3
    edges = np.quantile(pts[:, axis], [1 / 3, 2 / 3])
    part = np.digitize(pts[:, axis], edges)
    labels = category * num_parts_per_cat + part
    return pts, labels.astype(np.int32)


def make_detection_scene(
    seed: int,
    *,
    num_objects: int = 5,
    num_bg_points: int = 6000,
    points_per_object: int = 200,
    pc_range=(0.0, -39.68, -3.0, 69.12, 39.68, 1.0),
    num_classes: int = 1,
) -> Dict[str, np.ndarray]:
    """A lidar-like scene: ground-plane clutter + box-shaped clusters.

    Boxes are car-sized with yaw; points inside each box are dense, so a
    detector can learn localization from geometry alone.
    """
    rng = np.random.default_rng(seed)
    # Background: rough ground plane with distance falloff.
    r = rng.exponential(20.0, num_bg_points).clip(2, 68)
    theta = rng.uniform(-0.45 * np.pi, 0.45 * np.pi, num_bg_points)
    bx = r * np.cos(theta)
    by = r * np.sin(theta)
    bz = rng.normal(-1.6, 0.08, num_bg_points)
    bg = np.stack([bx, by, bz, rng.uniform(0, 0.3, num_bg_points)], -1)

    boxes, classes, obj_pts = [], [], []
    for i in range(num_objects):
        cls = int(rng.integers(0, num_classes))
        l, w, h = [(3.9, 1.6, 1.56), (0.8, 0.6, 1.73), (1.76, 0.6, 1.73)][
            cls % 3]
        cx = rng.uniform(5, 60)
        cy = rng.uniform(-30, 30)
        cz = -1.6 + h / 2
        yaw = rng.uniform(-np.pi, np.pi)
        local = np.stack([
            rng.uniform(-l / 2, l / 2, points_per_object),
            rng.uniform(-w / 2, w / 2, points_per_object),
            rng.uniform(-h / 2, h / 2, points_per_object)], -1)
        # Heading cue: real vehicles are front/back asymmetric (low
        # hood, high cabin). Cap the height of front-quarter points so
        # heading is learnable — a uniform box is 180-degree symmetric
        # and pins the direction classifier's CE at ln 2 forever.
        front = local[:, 0] > l / 4
        local[:, 2] = np.where(
            front, np.minimum(local[:, 2], -0.1 * h), local[:, 2])
        c, s = np.cos(yaw), np.sin(yaw)
        world = np.stack([
            cx + local[:, 0] * c - local[:, 1] * s,
            cy + local[:, 0] * s + local[:, 1] * c,
            cz + local[:, 2]], -1)
        inten = rng.uniform(0.4, 1.0, (points_per_object, 1))
        obj_pts.append(np.concatenate([world, inten], -1))
        boxes.append([cx, cy, cz, l, w, h, yaw])
        classes.append(cls)

    points = np.concatenate([bg] + obj_pts).astype(np.float32)
    rng.shuffle(points)
    # Keep only in-range points.
    m = ((points[:, 0] >= pc_range[0]) & (points[:, 0] < pc_range[3])
         & (points[:, 1] >= pc_range[1]) & (points[:, 1] < pc_range[4])
         & (points[:, 2] >= pc_range[2]) & (points[:, 2] < pc_range[5]))
    return {
        "points": points[m],
        "gt_boxes": np.asarray(boxes, np.float32),
        "gt_classes": np.asarray(classes, np.int32),
    }


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


def make_semantic_scene(
    seed: int, *, num_points: int = 16000, num_classes: int = 20,
) -> Dict[str, np.ndarray]:
    """SemanticKITTI-like scene with geometry-correlated labels.

    Label depends on height band + radial distance band, so a range-image
    segmenter can learn it.
    """
    rng = np.random.default_rng(seed)
    r = rng.exponential(18.0, num_points).clip(2.5, 75)
    theta = rng.uniform(-np.pi, np.pi, num_points)
    x = r * np.cos(theta)
    y = r * np.sin(theta)
    band = rng.integers(0, 3, num_points)
    z = np.where(band == 0, rng.normal(-1.6, 0.05, num_points),
                 np.where(band == 1, rng.uniform(-1.2, 0.5, num_points),
                          rng.uniform(0.5, 2.5, num_points)))
    pts = np.stack([x, y, z, rng.uniform(0, 1, num_points)], -1).astype(
        np.float32)
    rband = np.digitize(r, [10, 30]).astype(np.int64)
    labels = (band * 3 + rband) % num_classes
    return {"points": pts, "point_labels": labels.astype(np.int32)}


# ---------------------------------------------------------------------------
# On-disk materialization in the real formats: the same file trees, byte
# for byte, as the JAX package's writers.


def write_kitti_fixture(root: str, num_frames: int = 3, seed: int = 0) -> None:
    """Write velodyne/.bin + calib + label_2 in the KITTI layout."""
    os.makedirs(os.path.join(root, "training", "velodyne"), exist_ok=True)
    os.makedirs(os.path.join(root, "training", "calib"), exist_ok=True)
    os.makedirs(os.path.join(root, "training", "label_2"), exist_ok=True)
    # Identity-ish calibration: camera frame = lidar rotated (x=-y', z=x').
    P2 = np.array([[700.0, 0, 600, 45], [0, 700, 180, -0.3],
                   [0, 0, 1, 0.005]])
    R0 = np.eye(3)
    # lidar (x fwd, y left, z up) -> cam (x right, y down, z fwd)
    Tr = np.array([[0.0, -1, 0, 0], [0, 0, -1, -0.08], [1, 0, 0, -0.27]])
    ids = []
    for i in range(num_frames):
        scene = make_detection_scene(seed + i)
        fid = f"{i:06d}"
        ids.append(fid)
        scene["points"].astype(np.float32).tofile(
            os.path.join(root, "training", "velodyne", fid + ".bin"))
        with open(os.path.join(root, "training", "calib", fid + ".txt"),
                  "w") as f:
            f.write("P0: " + " ".join("%g" % v for v in P2.ravel()) + "\n")
            f.write("P1: " + " ".join("%g" % v for v in P2.ravel()) + "\n")
            f.write("P2: " + " ".join("%g" % v for v in P2.ravel()) + "\n")
            f.write("P3: " + " ".join("%g" % v for v in P2.ravel()) + "\n")
            f.write("R0_rect: " + " ".join("%g" % v for v in R0.ravel())
                    + "\n")
            f.write("Tr_velo_to_cam: "
                    + " ".join("%g" % v for v in Tr.ravel()) + "\n")
        with open(os.path.join(root, "training", "label_2", fid + ".txt"),
                  "w") as f:
            for box, cls in zip(scene["gt_boxes"], scene["gt_classes"]):
                x, y, z, l, w, h, yaw = box
                # lidar -> camera coords for the label file.
                cam = Tr @ np.array([x, y, z, 1.0])
                cam_bottom = cam + np.array([0, h / 2, 0])
                ry = -yaw - np.pi / 2
                name = ["Car", "Pedestrian", "Cyclist"][int(cls) % 3]
                f.write(
                    f"{name} 0.00 0 0.0 0 0 50 50 "
                    f"{h:.2f} {w:.2f} {l:.2f} "
                    f"{cam_bottom[0]:.2f} {cam_bottom[1]:.2f} "
                    f"{cam_bottom[2]:.2f} {ry:.2f}\n")
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")


def write_semantickitti_fixture(root: str, num_scans: int = 2,
                                seed: int = 0) -> None:
    """Write sequences/00/velodyne/*.bin + labels/*.label layout."""
    seq = os.path.join(root, "sequences", "00")
    os.makedirs(os.path.join(seq, "velodyne"), exist_ok=True)
    os.makedirs(os.path.join(seq, "labels"), exist_ok=True)
    for i in range(num_scans):
        scene = make_semantic_scene(seed + i)
        sid = f"{i:06d}"
        scene["points"].astype(np.float32).tofile(
            os.path.join(seq, "velodyne", sid + ".bin"))
        # semantic in lower 16 bits, instance id in upper 16.
        lab = (scene["point_labels"].astype(np.uint32)
               | (np.uint32(7) << 16))
        lab.tofile(os.path.join(seq, "labels", sid + ".label"))


def write_modelnet_fixture(root: str, num_per_class: int = 2,
                           num_classes: int = 4, seed: int = 0) -> None:
    """Write the modelnet40_normal_resampled-style txt layout."""
    names = [f"class{c:02d}" for c in range(num_classes)]
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "shape_names.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    train_ids = []
    for c, name in enumerate(names):
        os.makedirs(os.path.join(root, name), exist_ok=True)
        for k in range(num_per_class):
            pts = make_cls_cloud(seed * 131 + k, c, 256)
            normals = np.zeros_like(pts)
            arr = np.concatenate([pts, normals], -1)
            sid = f"{name}_{k:04d}"
            np.savetxt(os.path.join(root, name, sid + ".txt"), arr,
                       delimiter=",", fmt="%.6f")
            train_ids.append(sid)
    with open(os.path.join(root, "modelnet_train.txt"), "w") as f:
        f.write("\n".join(train_ids) + "\n")
