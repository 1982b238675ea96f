"""Checkpoint and resume (port of ``lisec_tpu/training/checkpoint.py``,
which uses orbax).

One ``torch.save`` file a saved step, ``<directory>/<step>.pt``, holding
``Pipeline.state_dict()``: the model's parameters and running
statistics, the optimizer's moments and step count, and the dropout
masks' generator where the pipeline has one. A file is written under a
temporary name and then renamed into place, so a run killed while
saving leaves no partial checkpoint for ``latest_step`` to pick; the
next save removes what such a run left.

The save policy is orbax's (``CheckpointManagerOptions(max_to_keep=keep,
save_interval_steps=every)``): a step is saved when it is past the
latest saved one and is a multiple of ``every``, or when the directory
holds no checkpoint yet; ``force`` saves regardless; the newest ``keep``
steps are kept.

On W ranks of a data mesh the directory must be one every rank sees:
rank 0 decides whether a step is saved and writes the file, every rank
waits for it at a barrier, and every rank restores.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

_NAME = re.compile(r"^(\d+)\.pt$")
_PARTIAL = re.compile(r"^\.\d+\.pt\.tmp$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, every: int = 500):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.every = every
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        """True iff ``save(step, ...)`` would write: callers skip the
        state's copy to the host otherwise."""
        latest = self.latest_step()
        if latest is None:
            return True
        return step > latest and step % self.every == 0

    def save(self, step: int, pipeline, force: bool = False) -> bool:
        """Write ``pipeline``'s training state as ``step``; returns
        whether it was written (on every rank of a data mesh, which all
        call this together)."""
        mesh = pipeline.mesh
        if not mesh.decide(force or self.should_save(step)):
            return False
        if mesh.rank == 0:
            self._write(step, pipeline)
        mesh.barrier()
        return True

    def _write(self, step: int, pipeline) -> None:
        for name in os.listdir(self.directory):
            if _PARTIAL.match(name):
                os.remove(os.path.join(self.directory, name))
        tmp = os.path.join(self.directory, f".{step}.pt.tmp")
        torch.save(pipeline.state_dict(), tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.keep]:
            os.remove(self._path(old))

    def restore(self, pipeline, step: Optional[int] = None
                ) -> Optional[int]:
        """Load ``step`` (the latest when None) into ``pipeline``;
        returns the step, or None when there is none. The file is read
        onto the host: the model's ``load_state_dict`` copies into its
        tensors on the device, the torch optimizer's puts each moment on
        its parameter's device, and the step counts and the generator's
        state stay on the host, where they belong."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        state = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        pipeline.load_state_dict(state)
        return step

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Holds no open resource."""
