"""Pipeline base (port of ``lisec_tpu/pipelines/base.py``).

A pipeline owns the model, its loss, its optimizer and its
post-processing on one explicit device. ``"cuda"`` is the default;
without a card it raises instead of running on the CPU, where only the
caller's ``device="cpu"`` runs the plain PyTorch versions of the kernels.
The model and the optimizer hold the training state (parameters,
running statistics, moments, step count), so there is no separate state
object; ``state_dict`` gathers it for a checkpoint.

``self.mesh`` is the data mesh (``parallel.make_mesh`` over
``train.num_devices``): on W ranks ``train_step`` takes the global batch,
each rank runs its rows, the batch reductions are global and the
gradients are summed over the ranks, as the JAX package's train step
jitted over its mesh computes; ``infer_dp`` predicts the global batch's
rows on their ranks. At world 1 both are the single-device program.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from lisec_tpu_torch.config import Config
from lisec_tpu_torch.data.collate import make_batches
from lisec_tpu_torch.data.wire import unpack_points_q16
from lisec_tpu_torch.parallel.mesh import (
    all_gather, all_reduce_grads, global_metrics, make_mesh, shard_batch,
    use_mesh)
from lisec_tpu_torch.training.loop import step_key
from lisec_tpu_torch.training.optim import make_optimizer


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def same_device(a, b) -> bool:
    """Whether two device specs name one device (``"cuda"`` is the
    current card, so it equals ``"cuda:0"`` when that is current)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True

    def index(d):
        return torch.cuda.current_device() if d.index is None else d.index
    return index(a) == index(b)


class Pipeline:
    """Subclasses set ``self.model`` (an ``nn.Module`` on ``self.device``
    with a ``reset_parameters(seed)``) in ``__init__`` and implement
    ``make_dataset``, ``loss``, ``predict`` and ``evaluate``."""

    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = make_mesh(cfg.train.num_devices, self.device,
                              process_local=bool(cfg.train.multihost))
        self.optimizer = None
        self.schedule = None

    # -- subclass API ------------------------------------------------------

    def make_dataset(self, split: str):
        raise NotImplementedError

    def loss(self, batch: Dict[str, torch.Tensor],
             rng: Optional[np.ndarray] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, aux metrics) of a batch of tensors on ``self.device``,
        with the model in the mode the caller set; ``rng`` is the step's
        dropout key (``step_key()`` when None), which only networks with
        dropout read."""
        raise NotImplementedError

    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Inference outputs from a batch of tensors on ``self.device``."""
        raise NotImplementedError

    def augment_fn(self, split: str):
        """Host-side augmentation hook; None = no augmentation."""
        return None

    def evaluate(self, max_batches: int = 0) -> Dict[str, float]:
        """The workload's metrics over its held-out split with the
        model's current weights (the first ``max_batches`` batches; 0:
        all)."""
        raise NotImplementedError

    # -- provided machinery ------------------------------------------------

    def device_batch(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch on the device (all of it at
        world 1; all of a process-local batch)."""
        return shard_batch(batch, self.mesh)

    def _whole_batch(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def init_state(self, seed: int = 0) -> None:
        """Fresh training state: the JAX package's initial parameters
        from ``seed`` (``models.common.reset_parameters``), running
        statistics at their initial values, a new optimizer at step 0."""
        self.model.reset_parameters(seed)
        self.optimizer, self.schedule = make_optimizer(
            self.model.parameters(), self.cfg.train)

    def state_dict(self) -> Dict:
        """The training state a checkpoint holds: the model's parameters
        and running statistics, the optimizer's moments and step count.
        The dropout masks need nothing more: they are a function of
        ``train.seed`` and the step."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        """Restore what ``state_dict`` returned, after ``init_state``. A
        checkpoint that also holds a dropout generator's state (written
        before the masks were keyed by the step) loads, the state
        ignored."""
        if self.optimizer is None:
            raise RuntimeError("call init_state() before load_state_dict()")
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])

    @property
    def step(self) -> int:
        """Train steps taken since ``init_state``."""
        return self.optimizer.count

    def step_key(self, step: Optional[int] = None) -> np.ndarray:
        """The JAX loop's key of train step ``step`` (the next one,
        ``self.step``, when None; 0 before ``init_state``):
        ``fold_in(PRNGKey(train.seed + 17), step)``."""
        if step is None:
            step = self.step if self.optimizer is not None else 0
        return step_key(self.cfg.train.seed, step)

    def forward_backward(self, batch: Dict[str, np.ndarray],
                         rng: Optional[np.ndarray] = None
                         ) -> Dict[str, torch.Tensor]:
        """The train-mode loss of a (global) batch and its gradients,
        added to the parameters' ``.grad``: on W ranks each rank's share
        of the loss is differentiated and the gradients are summed over
        the ranks, so every rank holds the global batch's. ``rng`` is
        the step's dropout key (``step_key()`` when None). Returns the
        loss's aux metrics plus ``loss``, global values, detached."""
        self.model.train()
        with use_mesh(self.mesh):
            loss, aux = self.loss(self.device_batch(batch), rng)
            loss.backward()
            all_reduce_grads(list(self.model.parameters()), self.mesh)
            aux = {k: v.detach() for k, v in aux.items()}
            aux["loss"] = loss.detach()
            return global_metrics(aux)

    def train_step(self, batch: Dict[str, np.ndarray],
                   rng: Optional[np.ndarray] = None
                   ) -> Dict[str, torch.Tensor]:
        """Forward, backward and one optimizer update on a batch (numpy
        arrays or tensors; on W ranks the global batch, of which each
        rank runs its rows), its dropout masks drawn under ``rng`` (the
        step's key, ``step_key()`` when None). Returns the loss's aux
        metrics plus ``loss`` and ``grad_norm`` (the global norm before
        clipping), as 0-dim tensors on the device."""
        if self.optimizer is None:
            raise RuntimeError("call init_state() before train_step()")
        self.optimizer.zero_grad()
        aux = self.forward_backward(batch, rng)
        aux["grad_norm"] = self.optimizer.step()
        return aux

    @torch.no_grad()
    def infer(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Batch (numpy arrays or tensors) in, outputs on the device out."""
        self.model.eval()
        return self.predict(self._whole_batch(batch))

    @torch.no_grad()
    def infer_dp(self, batch: Dict[str, np.ndarray]
                 ) -> Dict[str, torch.Tensor]:
        """Data-parallel ``infer`` of a global batch: each rank predicts
        its rows with no collective in the forward pass, and the outputs
        are gathered in rank order into the global batch's on every
        rank. ``infer`` at world 1."""
        self.model.eval()
        out = self.predict(self.device_batch(batch))
        with use_mesh(self.mesh):
            return {k: all_gather(v) for k, v in out.items()}

    @torch.no_grad()
    def infer_packed(self, packed: Dict[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
        """``infer`` from the int16 wire format (``data/wire.py``): the
        codes, counts and bounds cross to the device as they are, about
        half the bytes of ``infer``'s f32 points and bool mask, and are
        dequantized there. Pack on the host with
        ``data.wire.pack_points_q16``."""
        self.model.eval()
        return self.predict(unpack_points_q16(self._whole_batch(packed)))

    def eval_outputs(self, split: str, max_batches: int = 0
                     ) -> Iterator[Tuple[Dict[str, np.ndarray],
                                         Dict[str, np.ndarray]]]:
        """(batch, outputs) over ``split`` in order, in whole batches of
        ``train.batch_size``, the first ``max_batches`` of them (0: all),
        each batch's outputs moved to the host once, as numpy. Leaves the
        model in ``eval()``."""
        cfg = self.cfg
        batches = make_batches(self.make_dataset(split), cfg.budget,
                               cfg.train.batch_size, shuffle=False, epochs=1)
        for n, batch in enumerate(batches, 1):
            out = self.infer(batch)
            yield batch, {k: v.cpu().numpy() for k, v in out.items()}
            if max_batches and n >= max_batches:
                return
