"""KITTI detection dataset and calibration (copy of
``lisec_tpu/data/kitti.py``; velodyne files are read with numpy).

Real layout: ``training/velodyne/*.bin`` (N x 4 float32 x,y,z,intensity),
``training/calib/*.txt`` (P2, R0_rect, Tr_velo_to_cam), and
``training/label_2/*.txt`` (camera-frame boxes). Labels are converted to
lidar-frame 7-DoF boxes ``(x, y, z_center, l, w, h, yaw)`` at load time.
``fixture=True`` generates synthetic scenes with ground-truth boxes.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List

import numpy as np

from lisec_tpu_torch import native
from lisec_tpu_torch.data.fixtures import (
    make_detection_scene, make_detection_scene_hard)
from lisec_tpu_torch.registry import register_dataset

KITTI_CLASSES = ("Car", "Pedestrian", "Cyclist")


class Calibration:
    """KITTI calibration: camera <-> lidar coordinate transforms."""

    def __init__(self, path: str):
        vals = {}
        with open(path) as f:
            for line in f:
                if ":" not in line:
                    continue
                key, rest = line.split(":", 1)
                vals[key.strip()] = np.array(
                    [float(v) for v in rest.split()], np.float64)
        missing = [k for k in ("P2", "R0_rect", "Tr_velo_to_cam")
                   if k not in vals]
        if missing:
            raise ValueError(
                f"calib file {path!r} is missing keys {missing} "
                "(expected KITTI 'key: values' lines)")
        self.P2 = vals["P2"].reshape(3, 4)
        self.R0 = vals["R0_rect"].reshape(3, 3)
        self.Tr_velo_to_cam = vals["Tr_velo_to_cam"].reshape(3, 4)

    def lidar_to_rect(self, pts: np.ndarray) -> np.ndarray:
        """(N, 3) lidar -> rectified camera coords."""
        hom = np.concatenate([pts, np.ones((len(pts), 1))], -1)
        return (self.R0 @ (self.Tr_velo_to_cam @ hom.T)).T

    def rect_to_lidar(self, pts: np.ndarray) -> np.ndarray:
        """(N, 3) rectified camera -> lidar coords."""
        inv_r0 = np.linalg.inv(self.R0)
        cam = (inv_r0 @ pts.T).T
        T = np.eye(4)
        T[:3] = self.Tr_velo_to_cam
        inv = np.linalg.inv(T)
        hom = np.concatenate([cam, np.ones((len(cam), 1))], -1)
        return (inv @ hom.T).T[:, :3]

    def rect_to_img(self, pts: np.ndarray) -> np.ndarray:
        """(N, 3) rectified camera -> (N, 2) image pixels."""
        hom = np.concatenate([pts, np.ones((len(pts), 1))], -1)
        uvw = (self.P2 @ hom.T).T
        return uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-6)


class KittiObject:
    """One label_2 line parsed."""

    def __init__(self, line: str):
        parts = line.split()
        self.name = parts[0]
        self.truncation = float(parts[1])
        self.occlusion = int(float(parts[2]))
        self.alpha = float(parts[3])
        self.box2d = np.array([float(v) for v in parts[4:8]])
        self.h, self.w, self.l = (float(parts[8]), float(parts[9]),
                                  float(parts[10]))
        self.pos_cam = np.array([float(v) for v in parts[11:14]])
        self.ry = float(parts[14])
        self.score = float(parts[15]) if len(parts) > 15 else 1.0

    @property
    def difficulty(self) -> int:
        """KITTI Easy(0)/Moderate(1)/Hard(2), -1 = ignore — by 2D box
        height, occlusion, truncation (the published thresholds)."""
        height = self.box2d[3] - self.box2d[1]
        if height >= 40 and self.occlusion <= 0 and self.truncation <= 0.15:
            return 0
        if height >= 25 and self.occlusion <= 1 and self.truncation <= 0.30:
            return 1
        if height >= 25 and self.occlusion <= 2 and self.truncation <= 0.50:
            return 2
        return -1


def boxes_camera_to_lidar(objs: List[KittiObject],
                          calib: Calibration) -> np.ndarray:
    """Camera-frame labels -> lidar-frame (x, y, z_center, l, w, h, yaw)."""
    if not objs:
        return np.zeros((0, 7), np.float32)
    pos = np.stack([o.pos_cam for o in objs])           # bottom-center, cam
    xyz = Calibration.rect_to_lidar(calib, pos)
    out = []
    for o, p in zip(objs, xyz):
        yaw = -o.ry - np.pi / 2
        yaw = (yaw + np.pi) % (2 * np.pi) - np.pi       # wrap to [-pi, pi)
        out.append([p[0], p[1], p[2] + o.h / 2, o.l, o.w, o.h, yaw])
    return np.asarray(out, np.float32)


def read_velodyne(path: str) -> np.ndarray:
    """(N, 4) float32 x, y, z, intensity of one velodyne ``.bin``, read
    as the JAX package reads it (``native.read_velodyne``: whole points,
    at most 300,000, a partial trailing record dropped)."""
    return native.read_velodyne(path)


def get_label_objects(path: str) -> List[KittiObject]:
    with open(path) as f:
        return [KittiObject(l) for l in f if l.strip()]


# maxsize bounds host RAM at ~130 KB/scene: 1024 ≈ 130 MB, sized to an
# epoch's working set (hit rate comes from seed reuse across epochs,
# not cache breadth).
@functools.lru_cache(maxsize=1024)
def _fixture_scene_cached(seed: int, num_classes: int, hard: bool = False):
    if hard:
        return make_detection_scene_hard(seed, num_classes=num_classes)
    return make_detection_scene(seed, num_classes=num_classes)


def _fixture_scene(seed: int, num_classes: int,
                   hard: bool = False) -> Dict[str, np.ndarray]:
    """Fixture scenes are deterministic per (seed, classes) but cost
    tens of milliseconds to synthesize, so they are cached (~130 KB per
    scene) and handed out as array copies, which in-place augmentation
    cannot corrupt."""
    s = _fixture_scene_cached(seed, num_classes, hard)
    return {k: v.copy() if isinstance(v, np.ndarray) else v
            for k, v in s.items()}


@register_dataset("kitti")
class KittiDetection:
    def __init__(self, cfg, split: str = "train"):
        self.fixture = cfg.data.fixture
        self.split = split
        self.class_names = tuple(cfg.data.class_names) or KITTI_CLASSES
        if self.fixture:
            self.size = cfg.data.fixture_size
            self.num_classes = len(self.class_names)
            self.fixture_hard = bool(getattr(cfg.data, "fixture_hard",
                                             False))
            return
        root = cfg.data.root
        with open(os.path.join(root, f"{split}.txt")) as f:
            self.ids = [l.strip() for l in f if l.strip()]
        self.root = root
        self.size = len(self.ids)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if self.fixture:
            seed = i if self.split == "train" else 30_000 + i
            scene = _fixture_scene(seed, len(self.class_names),
                                   self.fixture_hard)
            if self.fixture_hard and self.split == "train":
                # Difficulty -1 = near-invisible (< 5 rays reach it):
                # keep it out of the positive-anchor supply, the same
                # reason the real recipe drops DontCare/filtered gts
                # from training targets (eval already ignores it).
                keep = scene["difficulty"] >= 0
                for k in ("gt_boxes", "gt_classes", "difficulty"):
                    scene[k] = scene[k][keep]
            return scene
        fid = self.ids[i]
        base = os.path.join(self.root, "training")
        points = read_velodyne(
            os.path.join(base, "velodyne", fid + ".bin"))
        calib = Calibration(os.path.join(base, "calib", fid + ".txt"))
        objs = [o for o in get_label_objects(
            os.path.join(base, "label_2", fid + ".txt"))
            if o.name in self.class_names]
        boxes = boxes_camera_to_lidar(objs, calib)
        classes = np.array(
            [self.class_names.index(o.name) for o in objs], np.int32)
        return {
            "points": points,
            "gt_boxes": boxes,
            "gt_classes": classes,
            "difficulty": np.array([o.difficulty for o in objs], np.int32),
            "frame_id": fid,
        }
