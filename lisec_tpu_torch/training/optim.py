"""Optimizer and learning-rate schedule factory (port of
``lisec_tpu/training/optim.py``, which builds them from optax).

Schedules are plain functions of the step count. The optimizers are
``torch.optim`` ones with optax's defaults (Adam eps 1e-8; AdamW decays
every parameter; SGD momentum 0.9), behind ``Optimizer``, which applies
optax's global-norm clip and the schedule before each step.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch

from lisec_tpu_torch.config import TrainConfig

Schedule = Callable[[int], float]


def _cosine_interpolate(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def make_schedule(cfg: TrainConfig) -> Schedule:
    """The learning rate as a function of the number of steps taken."""
    lr, total = cfg.lr, cfg.num_steps
    if cfg.schedule == "onecycle":
        # optax.cosine_onecycle_schedule(div_factor=10,
        # final_div_factor=100): cosine from lr / 10 up to lr at
        # int(warmup_frac * T), then down to lr / 1000 at T. Not
        # torch.optim.lr_scheduler.OneCycleLR's shape.
        if total <= 0:
            raise ValueError("onecycle needs train.num_steps > 0")
        peak_at = int(cfg.warmup_frac * total)
        init, final = lr / 10.0, lr / 1000.0

        def onecycle(step):
            if step < peak_at:
                return _cosine_interpolate(init, lr, step / peak_at)
            if step < total:
                return _cosine_interpolate(
                    lr, final, (step - peak_at) / (total - peak_at))
            return final
        return onecycle
    if cfg.schedule == "cosine":
        # Linear warm-up from lr / 10, then cosine decay to 0 at T.
        warmup = max(int(total * cfg.warmup_frac), 1)
        decay = total - warmup
        if decay <= 0:
            raise ValueError("cosine needs num_steps above its warm-up")

        def cosine(step):
            if step < warmup:
                return lr / 10.0 + (lr - lr / 10.0) * (step / warmup)
            t = min(step - warmup, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return cosine
    if cfg.schedule == "step":
        every = cfg.step_decay_every or max(total // 3, 1)
        rate = cfg.step_decay_rate
        return lambda step: lr * rate ** (step // every)
    if cfg.schedule == "constant":
        return lambda step: lr
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


class Optimizer:
    """A ``torch.optim`` optimizer driven the way the JAX package drives
    optax: clip the gradients by their global norm, set the scheduled
    learning rate, update."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 cfg: TrainConfig):
        self.params = list(params)
        self.schedule = make_schedule(cfg)
        self.clip_norm = float(cfg.grad_clip_norm)
        self.count = 0                       # steps taken
        lr0 = self.schedule(0)
        if cfg.optimizer == "adamw":
            self.opt = torch.optim.AdamW(
                self.params, lr=lr0, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=cfg.weight_decay)
        elif cfg.optimizer == "adam":
            self.opt = torch.optim.Adam(self.params, lr=lr0,
                                        betas=(0.9, 0.999), eps=1e-8)
        elif cfg.optimizer == "sgd":
            self.opt = torch.optim.SGD(self.params, lr=lr0, momentum=0.9)
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad``. Returns the global
        gradient norm before clipping (a 0-dim tensor; no host sync)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        if self.clip_norm > 0:
            # optax.clip_by_global_norm: untouched below the limit, else
            # (g / norm) * limit.
            below = norm < self.clip_norm
            div = torch.where(below, 1.0, norm)
            mul = torch.where(below, 1.0, self.clip_norm)
            for g in grads:
                g.div_(div).mul_(mul)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "optimizer": self.opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.opt.load_state_dict(state["optimizer"])


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: TrainConfig
                   ) -> Tuple[Optimizer, Schedule]:
    opt = Optimizer(params, cfg)
    return opt, opt.schedule
