"""The weights a cell runs with, made or loaded by the benchmark and handed
to both the program and the reference as flat arrays in the flax layout
(``params/<module path>/<leaf>``, ``batch_stats/...``).

``snapshot``: a committed weight file, checked against the sha256 that
the configuration records, so the yardstick cannot move under it.
``seed``: drawn on the device from the configuration's ``weight_seed``
with one ``torch.Generator`` and one normal draw for all kernels: each
kernel N(0, gain / fan_in) with the configuration's ``gain`` (for the
anchor head's class, box and direction convs ``head_gains``, in that
order), biases and BatchNorm shifts 0, scales and running variances 1,
running means 0, the class bias at ``class_bias``. With
``calibrate_clouds``, ``calibrate`` then sets every BatchNorm's running
statistics to its input's over that many clouds of the generator
``calibrate_scenes`` made from the same seed, in the reference, counting
only the rows that hold a non-zero value (a lidar BEV map is mostly
empty; statistics over the empty cells too would blow the occupied ones
up layer after layer), and the class bias so that ``positive_share`` of
the anchors score above the threshold, as a trained detector's sparse
scores do; random weights with unit statistics would leave every score
at the focal prior, below the threshold, and NMS with nothing to do.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from types import ModuleType
from typing import Dict, Tuple

import numpy as np
import torch


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def snapshot(spec: Dict, root: Path) -> Dict[str, np.ndarray]:
    path = root / spec["file"]
    digest = _sha256(path)
    if digest != spec["sha256"]:
        raise RuntimeError(f"{spec['file']} has sha256 {digest}, the "
                           f"configuration records {spec['sha256']}")
    with np.load(path) as data:
        return {k: np.asarray(data[k], np.float32) for k in data.files}


def seed_draw(layout: Dict[str, Tuple[int, ...]], spec: Dict, seed: int,
              device) -> Dict[str, torch.Tensor]:
    """Flat arrays of the given keys and shapes, drawn on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    kernels = sorted(k for k in layout if k.endswith("/kernel"))
    total = sum(int(np.prod(layout[k])) for k in kernels)
    noise = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for key in sorted(layout):
        shape = tuple(layout[key])
        leaf = key.rsplit("/", 1)[1]
        if leaf == "kernel":
            n = int(np.prod(shape))
            fan_in = int(np.prod(shape[:-1]))
            gain = spec["gain"]
            if "AnchorHead_0/Conv_" in key:
                gain = spec["head_gains"][int(key.split("Conv_")[1][0])]
            out[key] = noise[at:at + n].view(shape) * (gain / fan_in) ** 0.5
            at += n
        elif leaf in ("scale", "var"):
            out[key] = torch.ones(shape, device=device)
        else:
            out[key] = torch.zeros(shape, device=device)
    cls_bias = [k for k in out if k.endswith("AnchorHead_0/Conv_0/bias")]
    for k in cls_bias:
        out[k].fill_(float(spec["class_bias"]))
    return out


def calibrate(w: Dict[str, torch.Tensor], spec: Dict, points: torch.Tensor,
              counts: torch.Tensor, cfg: Dict, model: ModuleType) -> None:
    """Running statistics and class bias of a seed draw, in place (see the
    module's note), from the reference ``model`` over ``points``."""
    import math

    from portbench import reference
    n = int(spec["calibrate_clouds"])
    with torch.no_grad(), reference.exact_float32():
        for i in range(n):
            model.forward(points[i:i + 1], counts[i:i + 1], w, cfg,
                          calibrate=True)
        bias = [k for k in w if k.endswith("AnchorHead_0/Conv_0/bias")][0]
        w[bias].zero_()
        logits = torch.cat([model.forward(points[i:i + 1], counts[i:i + 1],
                                          w, cfg)["cls"].flatten()
                            for i in range(n)])
    thr = float(cfg["model"]["params"].get("score_threshold", 0.1))
    top = torch.quantile(logits.float(), 1.0 - float(spec["positive_share"]))
    w[bias].fill_(math.log(thr / (1.0 - thr)) - float(top))
