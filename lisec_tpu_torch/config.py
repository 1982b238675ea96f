"""Typed config system (SURVEY.md §5.6, R7).

Configs are nested dataclasses serialized to/from YAML, one file per
workload under ``configs/``. CLI overrides use dotted ``key=value``
syntax. Shape **budgets** (max points / pillars / voxels / boxes /
rulebook pairs) live here, not in code: they define the static shapes
XLA compiles against — one compilation per (model, budget) pair.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import yaml


@dataclass
class VoxelConfig:
    """Grid geometry for voxelization / pillarization (O1)."""

    # [x_min, y_min, z_min, x_max, y_max, z_max] in lidar frame.
    point_cloud_range: Tuple[float, float, float, float, float, float] = (
        0.0, -39.68, -3.0, 69.12, 39.68, 1.0)
    voxel_size: Tuple[float, float, float] = (0.16, 0.16, 4.0)

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        """(nx, ny, nz) — number of cells along each axis."""
        r = self.point_cloud_range
        v = self.voxel_size
        return (
            int(round((r[3] - r[0]) / v[0])),
            int(round((r[4] - r[1]) / v[1])),
            int(round((r[5] - r[2]) / v[2])),
        )


@dataclass
class BudgetConfig:
    """Static-shape budgets. Every dynamic count in the pipeline becomes
    a budget + validity mask (SURVEY.md §7 design invariants)."""

    max_points: int = 32768          # padded cloud size fed to device
    max_voxels: int = 12000          # pillars (PointPillars) or voxels (SECOND)
    max_points_per_voxel: int = 32
    max_boxes: int = 64              # gt boxes per frame
    nms_pre: int = 1024              # top-k kept before NMS
    nms_post: int = 128              # boxes returned
    nms_near: int = 64               # exact-IoU candidates per emission
                                     # (0 = full rows; see ops/nms.py)
    nms_block: int = 16              # emissions per block-greedy round
    nms_select: str = "topk"         # per-round block select: topk|scan
    nms_class_parallel: bool = True  # one greedy stream per class
                                     # (vmapped; exact — see ops/nms.py)
    max_rulebook_pairs: int = 65536  # per kernel-offset pair budget (O7/O8)


@dataclass
class ModelConfig:
    name: str = "pointnet_cls"
    # Free-form per-model hyperparameters; each model class documents its
    # own keys and reads them with defaults.
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class AugmentConfig:
    """Per-cloud augmentation (D5)."""

    enabled: bool = True
    # cls/seg-style
    rotate_z: bool = True
    jitter_sigma: float = 0.01
    jitter_clip: float = 0.05
    scale_range: Tuple[float, float] = (0.95, 1.05)
    dropout_max: float = 0.0
    # detection-style
    global_flip_y: bool = False
    global_rotate: float = 0.0        # uniform(-r, r) about z
    global_translate_std: float = 0.0
    gt_sampling: bool = False
    gt_sample_max_per_class: int = 15
    box_noise_rot: float = 0.0
    box_noise_trans: float = 0.0


@dataclass
class DataConfig:
    dataset: str = "modelnet40"
    root: str = "data/modelnet40"
    num_points: int = 1024
    num_classes: int = 40
    # detection class setup
    class_names: Tuple[str, ...] = ()
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    # fixture mode: generate a deterministic synthetic dataset instead of
    # reading `root` (used when real data is absent; SURVEY.md §4).
    fixture: bool = False
    fixture_size: int = 64
    # hard fixture variant (detection only): ray-cast scenes with
    # occlusion / truncation / ring density falloff / distractors and
    # per-gt difficulty (data/fixtures.py::make_detection_scene_hard).
    fixture_hard: bool = False


@dataclass
class TrainConfig:
    batch_size: int = 16
    num_steps: int = 1000
    optimizer: str = "adamw"          # adam | adamw | sgd
    lr: float = 1e-3
    weight_decay: float = 1e-4
    schedule: str = "onecycle"        # onecycle | step | cosine | constant
    warmup_frac: float = 0.1
    step_decay_every: int = 0
    step_decay_rate: float = 0.7
    grad_clip_norm: float = 10.0
    seed: int = 0
    log_every: int = 50
    eval_every: int = 500
    ckpt_dir: str = "runs/default"
    ckpt_keep: int = 3
    ckpt_every: int = 500
    resume: str = ""                  # "" | "auto" | explicit path
    num_devices: int = 0              # 0 = use all visible devices (DP)
    debug_nans: bool = False          # jax_debug_nans for CI runs (§5.2)
    tensorboard: bool = False         # TB event files next to metrics.jsonl
    # P2 multi-host launcher (SURVEY.md §2.4): one process per host.
    multihost: bool = False           # jax.distributed.initialize at startup
    coordinator: str = ""             # "" = TPU-pod auto-detect
    num_processes: int = 0            # 0 = auto-detect
    process_id: int = -1              # -1 = auto-detect


@dataclass
class Config:
    workload: str = "pointnet_modelnet40"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    voxel: VoxelConfig = field(default_factory=VoxelConfig)
    budget: BudgetConfig = field(default_factory=BudgetConfig)


# ---------------------------------------------------------------------------
# dict / YAML round-trip


def _from_dict(cls, d: Dict[str, Any]):
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs = {}
    hints = {f.name: f for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if k not in hints:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        f = hints[k]
        if dataclasses.is_dataclass(f.type) and isinstance(v, dict):
            kwargs[k] = _from_dict(f.type, v)
        elif isinstance(v, dict) and f.name in _NESTED:
            kwargs[k] = _from_dict(_NESTED[f.name], v)
        elif isinstance(v, list) and _is_tuple_field(f):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


_NESTED = {
    "model": ModelConfig,
    "data": DataConfig,
    "train": TrainConfig,
    "voxel": VoxelConfig,
    "budget": BudgetConfig,
    "augment": AugmentConfig,
}


def _is_tuple_field(f: dataclasses.Field) -> bool:
    t = str(f.type)
    return t.startswith("Tuple") or t.startswith("tuple")


def config_from_dict(d: Dict[str, Any]) -> Config:
    return _from_dict(Config, d)


def config_to_dict(cfg: Config) -> Dict[str, Any]:
    def conv(o):
        if dataclasses.is_dataclass(o):
            return {f.name: conv(getattr(o, f.name))
                    for f in dataclasses.fields(o)}
        if isinstance(o, tuple):
            return [conv(x) for x in o]
        if isinstance(o, dict):
            return {k: conv(v) for k, v in o.items()}
        return o
    return conv(cfg)


def load_config(path: str) -> Config:
    with open(path) as f:
        d = yaml.safe_load(f) or {}
    return config_from_dict(d)


def save_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(config_to_dict(cfg), f, sort_keys=False)


# ---------------------------------------------------------------------------
# CLI overrides: "train.lr=3e-4 budget.max_voxels=16000 model.params.width=2"


def _parse_value(s: str) -> Any:
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def apply_overrides(cfg: Config, overrides: List[str]) -> Config:
    d = config_to_dict(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, val = ov.split("=", 1)
        parts = key.split(".")
        node = d
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                if p == "params" and isinstance(node.get(p), dict):
                    pass
                elif p not in node:
                    raise KeyError(f"unknown config path {key!r}")
            node = node[p]
        leaf = parts[-1]
        if leaf not in node and parts[-2:][0] != "params" and "params" not in parts:
            raise KeyError(f"unknown config key {key!r}")
        node[leaf] = _parse_value(val)
    return config_from_dict(d)
