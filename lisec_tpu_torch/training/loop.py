"""Training loop (port of ``lisec_tpu/training/loop.py``).

The host feeds fixed-shape batches; each ``train_step`` runs forward,
backward and the update on the pipeline's device. Metrics, and every
``train.eval_every`` steps the pipeline's ``evaluate``, go to the history
and to a JSONL file when a path is given. Checkpointing with resume,
multi-host launch, the TensorBoard mirror and NaN debugging are not
ported yet: a config that asks for one raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

from lisec_tpu_torch.config import Config

class MetricsLogger:
    """Structured JSONL metrics writer (``path`` None: keeps nothing)."""

    def __init__(self, path: Optional[str]):
        self.file = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self.file = open(path, "a")

    def log(self, record: Dict) -> None:
        if self.file:
            self.file.write(json.dumps(record) + "\n")
            self.file.flush()

    def close(self) -> None:
        if self.file:
            self.file.close()


def _refuse_unported(cfg: Config) -> None:
    t = cfg.train
    for asked, what in (
            (t.ckpt_dir, "checkpointing (train.ckpt_dir)"),
            (t.resume, "resume (train.resume)"),
            (t.multihost, "multi-host training (train.multihost)"),
            (t.num_devices > 1, "data-parallel training "
                                "(train.num_devices > 1)"),
            (t.tensorboard, "the TensorBoard mirror (train.tensorboard)"),
            (t.debug_nans, "NaN debugging (train.debug_nans)")):
        if asked:
            raise NotImplementedError(
                f"{what} is not ported to lisec_tpu_torch yet")


def run_training(cfg: Config, device="cuda", progress: bool = True,
                 metrics_path: Optional[str] = None
                 ) -> Tuple[object, List[Dict]]:
    """Train per config on ``device``; returns (pipeline, history). The
    pipeline's model and optimizer hold the final state."""
    from lisec_tpu_torch.api import build_model
    from lisec_tpu_torch.data.collate import make_batches, prefetch

    _refuse_unported(cfg)
    pipeline = build_model(cfg, device=device)
    pipeline.init_state(cfg.train.seed)
    logger = MetricsLogger(metrics_path)

    # The batch stream is seekable (shuffle order derives from the seed
    # and the epoch), and the same as the JAX package's.
    batches = prefetch(make_batches(
        pipeline.make_dataset("train"), cfg.budget, cfg.train.batch_size,
        shuffle=True, seed=cfg.train.seed,
        augment_fn=pipeline.augment_fn("train"), start_batch=0))
    history: List[Dict] = []
    t0 = time.time()
    samples_done = 0
    for step in range(cfg.train.num_steps):
        aux = pipeline.train_step(next(batches))
        samples_done += cfg.train.batch_size
        if (step + 1) % cfg.train.log_every == 0 or step == 0:
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
                print(f"[train {step + 1}/{cfg.train.num_steps}] {msg}",
                      flush=True)
        if cfg.train.eval_every and (step + 1) % cfg.train.eval_every == 0:
            # evaluate() leaves the model in eval(); the next train_step
            # puts it back in train().
            metrics = pipeline.evaluate()
            rec = {"step": step + 1, "eval": metrics}
            history.append(rec)
            logger.log(rec)
            if progress:
                print(f"[eval {step + 1}] {metrics}", flush=True)
    logger.close()
    return pipeline, history


def run_evaluation(cfg: Config, pipeline=None, device="cuda"
                   ) -> Dict[str, float]:
    """Evaluate a config: ``pipeline``'s current weights, or, with none
    given, a new pipeline on ``device`` initialised by
    ``init_state(train.seed)``. Restoring a checkpoint first
    (``train.ckpt_dir``) is not ported yet and raises."""
    if cfg.train.ckpt_dir:
        raise NotImplementedError(
            "restoring a checkpoint (train.ckpt_dir) before evaluating is "
            "not ported to lisec_tpu_torch yet")
    if pipeline is None:
        from lisec_tpu_torch.api import build_model
        pipeline = build_model(cfg, device=device)
        pipeline.init_state(cfg.train.seed)
    metrics = pipeline.evaluate()
    print(json.dumps(metrics, indent=2))
    return metrics
