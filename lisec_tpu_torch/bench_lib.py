"""Weight files and timers (port of ``lisec_tpu/bench_lib.py``).

``save_weights_npz`` and ``load_weights_npz`` write and read the JAX
package's flat npz snapshots; ``_fixture_batch`` is its fixture batch;
``event_seconds`` (CUDA events) and ``wall_seconds`` (host clock) time a
call on the card. The port is measured end to end by
``python3 portbench/run.py --workload <cell>``, not here.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lisec_tpu_torch.config import Config
from lisec_tpu_torch.weights import load_weights_npz, to_flax_arrays

__all__ = ["event_seconds", "load_weights_npz", "save_weights_npz",
           "wall_seconds"]


def save_weights_npz(model: torch.nn.Module, path: str) -> None:
    """Write the model's parameters and running statistics as a flat npz
    under the JAX package's ``params/...`` and ``batch_stats/...`` names
    and layouts (``weights.to_flax_arrays``): the JAX package's
    ``load_weights_npz`` reads it, and ``load_weights_npz`` here reads
    the JAX package's snapshots."""
    np.savez_compressed(path, **to_flax_arrays(model))


def event_seconds(fn, iters: int, warmup: int = 2) -> float:
    """Seconds per call of ``fn()``: ``iters`` calls back to back between
    two CUDA events on the current stream, one synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 1e3 / iters


def _fixture_batch(cfg: Config, batch_size: int, seed: int = 0):
    from lisec_tpu_torch.data.collate import make_batches
    from lisec_tpu_torch.data.kitti import KittiDetection

    ds = KittiDetection(cfg, "train")
    return next(make_batches(ds, cfg.budget, batch_size, shuffle=False,
                             seed=seed))


def wall_seconds(call, warmup: int, iters: int) -> float:
    """Wall seconds per ``call()``, each one ending with its boxes on
    the host."""
    for _ in range(warmup):
        call()["boxes"].cpu()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()["boxes"].cpu()
    return (time.perf_counter() - t0) / iters
