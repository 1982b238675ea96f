"""Training loop (port of ``lisec_tpu/training/loop.py``).

The host feeds fixed-shape batches; each ``train_step`` runs forward,
backward and the update on the pipeline's device. Metrics, and every
``train.eval_every`` steps the pipeline's ``evaluate``, go to the history
and to ``metrics.jsonl`` under ``train.ckpt_dir`` (with a TensorBoard
mirror under ``tb/`` beside it when ``train.tensorboard`` is set).
Checkpoints go to ``train.ckpt_dir`` every ``train.ckpt_every`` steps and
at the last; ``train.resume`` restarts from the latest of them, the
batch stream included. ``train.debug_nans`` stops the run at the first
non-finite loss or gradient norm.

Data parallelism: with ``train.num_devices`` W > 1 the run is one
process a rank of a process group that is up (``torchrun``, or
``parallel.initialize_distributed``); every rank builds the global batch
stream from ``train.seed`` and runs its rows, so W ranks train what one
device trains on the same batches. With ``train.multihost`` the loop
brings the group up itself (``train.coordinator``, ``num_processes``,
``process_id``, else ``torchrun``'s environment, else it trains on one
process) and each rank reads its own shard of the examples
(``ProcessShardDataset``, seed ``train.seed + rank``) at a local batch of
``batch_size / W``, as the JAX package's hosts do. Only rank 0 writes
metrics, TensorBoard, progress lines and checkpoints; every rank keeps
the history (global values) and restores a checkpoint.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from lisec_tpu_torch.config import Config
from lisec_tpu_torch.utils import prng

# The JAX loop keys its train steps from ``train.seed`` plus this.
STEP_KEY_OFFSET = 17


def step_key(seed: int, step: int) -> np.ndarray:
    """The key of train step ``step`` (from 0), as the JAX loop draws it:
    ``fold_in(PRNGKey(seed + 17), step)``. The dropout masks of the step
    derive from it, so a resumed run draws what an unbroken one does."""
    return prng.fold_in(prng.PRNGKey(seed + STEP_KEY_OFFSET), step)


class MetricsLogger:
    """Structured JSONL metrics writer (``path`` None: keeps nothing),
    with an optional TensorBoard scalar mirror in ``tb/`` beside it."""

    def __init__(self, path: Optional[str], tensorboard: bool = False):
        self.file = None
        self.tb = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self.file = open(path, "a")
            if tensorboard:
                from lisec_tpu_torch.utils.tb_writer import TensorBoardWriter
                self.tb = TensorBoardWriter(
                    os.path.join(os.path.dirname(path) or ".", "tb"))

    def log(self, record: Dict) -> None:
        if self.file:
            self.file.write(json.dumps(record) + "\n")
            self.file.flush()
        if self.tb:
            step = int(record.get("step", 0))
            self.tb.write_scalars(
                step, {k: v for k, v in record.items() if k != "step"})

    def close(self) -> None:
        if self.file:
            self.file.close()
        if self.tb:
            self.tb.close()


def _check_finite(aux: Dict[str, torch.Tensor], step: int) -> None:
    for k in ("loss", "grad_norm"):
        if not torch.isfinite(aux[k]):
            raise FloatingPointError(
                f"train.debug_nans: {k} is {float(aux[k])} at step {step}")


def run_training(cfg: Config, device="cuda", progress: bool = True,
                 metrics_path: Optional[str] = None
                 ) -> Tuple[object, List[Dict]]:
    """Train per config on ``device``; returns (pipeline, history). The
    pipeline's model and optimizer hold the final state. Metrics go to
    ``metrics_path``, else to ``metrics.jsonl`` under ``train.ckpt_dir``
    when that is set."""
    from lisec_tpu_torch.api import build_model
    from lisec_tpu_torch.data.collate import make_batches, prefetch
    from lisec_tpu_torch.parallel.mesh import (
        ProcessShardDataset, initialize_distributed)
    from lisec_tpu_torch.training.checkpoint import CheckpointManager

    t = cfg.train
    if t.multihost:
        initialize_distributed(
            t.coordinator or None, t.num_processes or None,
            t.process_id if t.process_id >= 0 else None, device=device)
    pipeline = build_model(cfg, device=device)
    pipeline.init_state(t.seed)
    mesh = pipeline.mesh
    lead = mesh.rank == 0
    progress = progress and lead

    ckpt = None
    if t.ckpt_dir:
        ckpt = CheckpointManager(t.ckpt_dir, keep=t.ckpt_keep,
                                 every=t.ckpt_every)
        if t.resume:
            ckpt.restore(pipeline)
    if metrics_path is None and t.ckpt_dir:
        metrics_path = os.path.join(t.ckpt_dir, "metrics.jsonl")
    logger = MetricsLogger(metrics_path if lead else None,
                           tensorboard=t.tensorboard)

    # The batch stream is seekable (shuffle order derives from the seed
    # and the epoch, augmentation from the batch index), and the same as
    # the JAX package's, so a resumed run sees the batches the unbroken
    # one would have.
    start_step = pipeline.step
    dataset = pipeline.make_dataset("train")
    batch_size, seed = t.batch_size, t.seed
    if mesh.process_local and mesh.world > 1:
        if t.batch_size % mesh.world:
            raise ValueError(f"train.batch_size={t.batch_size} does not "
                             f"split over {mesh.world} processes")
        dataset = ProcessShardDataset(dataset, mesh.rank, mesh.world)
        batch_size //= mesh.world
        seed += mesh.rank
    batches = prefetch(make_batches(
        dataset, cfg.budget, batch_size, shuffle=True, seed=seed,
        augment_fn=pipeline.augment_fn("train"), start_batch=start_step))
    history: List[Dict] = []
    t0 = time.time()
    samples_done = 0
    for step in range(start_step, t.num_steps):
        aux = pipeline.train_step(next(batches), step_key(t.seed, step))
        samples_done += t.batch_size
        if t.debug_nans:
            _check_finite(aux, step + 1)
        if (step + 1) % t.log_every == 0 or step == start_step:
            # float() waits for the device, so the rate is of finished work.
            aux_host = {k: float(v) for k, v in aux.items()}
            elapsed = time.time() - t0
            rec = {
                "step": step + 1,
                "lr": float(pipeline.schedule(step)),
                "clouds_per_sec": samples_done / max(elapsed, 1e-9),
                **aux_host,
            }
            history.append(rec)
            logger.log(rec)
            if progress:
                msg = " ".join(f"{k}={v:.4g}" for k, v in rec.items()
                               if isinstance(v, float))
                print(f"[train {step + 1}/{t.num_steps}] {msg}", flush=True)
        if ckpt is not None:
            ckpt.save(step + 1, pipeline)
        if t.eval_every and (step + 1) % t.eval_every == 0:
            # evaluate() leaves the model in eval(); the next train_step
            # puts it back in train().
            metrics = pipeline.evaluate()
            rec = {"step": step + 1, "eval": metrics}
            history.append(rec)
            logger.log(rec)
            if progress:
                print(f"[eval {step + 1}] {metrics}", flush=True)

    if ckpt is not None:
        ckpt.save(t.num_steps, pipeline,
                  force=ckpt.latest_step() != t.num_steps)
        ckpt.wait()
        ckpt.close()
    logger.close()
    return pipeline, history


def run_evaluation(cfg: Config, pipeline=None, device="cuda"
                   ) -> Dict[str, float]:
    """Evaluate a config: ``pipeline``'s current weights, or, with none
    given, a new pipeline on ``device`` initialised by
    ``init_state(train.seed)`` and then restored from the latest
    checkpoint of ``train.ckpt_dir`` when there is one."""
    if pipeline is None:
        from lisec_tpu_torch.api import build_model
        from lisec_tpu_torch.training.checkpoint import CheckpointManager
        pipeline = build_model(cfg, device=device)
        pipeline.init_state(cfg.train.seed)
        if cfg.train.ckpt_dir:
            CheckpointManager(cfg.train.ckpt_dir).restore(pipeline)
    metrics = pipeline.evaluate()
    print(json.dumps(metrics, indent=2))
    return metrics
