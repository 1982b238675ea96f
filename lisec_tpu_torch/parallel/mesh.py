"""Data-parallel mesh, launcher and sharded feed (port of
``lisec_tpu/parallel/mesh.py``).

The JAX package jits its train step over a 1-D ``('data',)`` mesh with
the batch axis sharded and the parameters replicated, so every
reduction over the batch (train-mode BatchNorm statistics, a loss's
denominator, the Lovász sort) is over the GLOBAL batch: XLA inserts the
collectives. The port runs one process a rank and makes those
reductions global by hand, through the helpers here, inside
``use_mesh(mesh)``:

* ``global_sum`` (with autograd), ``global_mean`` and ``all_gather``
  (with autograd, rank order) over the active mesh;
* ``mean_share`` and ``Mesh.rows`` for a rank's share of a batch mean
  and of a draw made for the global batch.

The convention is that a loss on W ranks is the SUM of the ranks'
shares: each rank's ``loss`` is its own rows' part of the global loss,
and ``Pipeline.train_step`` sums the ranks' gradients
(``all_reduce_grads``). The backward of ``global_sum`` and of
``all_gather`` is itself a SUM over ranks of the cotangents; that is
the gradient of the summed loss as long as every rank keeps only its
own share of a term (a rank that computes a term from gathered inputs
keeps 1/W of it), so no rank counts another's part twice.

With no process group up, or one of size 1, nothing of this runs a
collective or makes a tensor: every helper returns its argument, or
the plain reduction the single-device program takes.

Only ``all_reduce`` and ``broadcast`` are used (an all-gather is an
``all_reduce`` SUM into a zero buffer, each rank writing its own slot),
so one code path runs on gloo over CPU tensors, on gloo over CUDA
tensors (ranks sharing one card) and on NCCL (one rank a card, as
``torchrun`` launches it).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import tempfile
from typing import Any, Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

_LAUNCH_HINT = ("launch one process a rank, e.g. `torchrun "
                "--nproc_per_node {w} -m lisec_tpu_torch.cli train <config> "
                "train.num_devices={w}`, or call "
                "lisec_tpu_torch.parallel.initialize_distributed first")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device="cuda") -> bool:
    """Bring up the default process group; returns whether it did.

    With explicit arguments the group meets at ``coordinator_address``
    (``host:port`` for TCP, or a URL such as ``file:///path``); what is
    not given comes from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``). With neither,
    or with a group already up, it does nothing and returns False, as
    the JAX function does on a single host. An explicitly requested
    launch that fails raises: degrading it to independent single-rank
    runs would train W different models.

    The backend is NCCL for a ``cuda`` device and gloo for ``cpu``
    unless ``backend`` names one; one never stands in for the other.
    On the card each rank makes its local rank's card (``LOCAL_RANK``,
    else the rank, modulo the cards it sees) current: a kernel launched
    through ``ctypes`` goes to the current card.
    """
    if dist.is_initialized():
        return False
    env = os.environ
    explicit = any(v is not None for v in
                   (coordinator_address, num_processes, process_id))
    if not explicit and not all(k in env for k in (
            "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        return False

    def given(value, key: str, what: str) -> int:
        if value is not None:
            return int(value)
        if key not in env:
            raise ValueError(f"initialize_distributed: no {what} given "
                             f"and ${key} is not set")
        return int(env[key])

    rank = given(process_id, "RANK", "process_id")
    world = given(num_processes, "WORLD_SIZE", "num_processes")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dev = torch.device(device)
    if backend is None:
        backend = {"cuda": "nccl", "cpu": "gloo"}[dev.type]
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return True


class ProcessShardDataset:
    """A rank's strided shard of an indexable dataset: rank p of P sees
    examples p, p + P, p + 2P, ...; every rank gets ``len // P`` of them
    (the ragged tail dropped), so the ranks' batches line up every
    step."""

    def __init__(self, dataset, process_id: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.dataset = dataset
        up = dist.is_initialized()
        if process_id is None:
            process_id = dist.get_rank() if up else 0
        if process_count is None:
            process_count = dist.get_world_size() if up else 1
        self.pid, self.pcount = process_id, process_count
        self._len = len(dataset) // self.pcount

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, i: int):
        return self.dataset[i * self.pcount + self.pid]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis: ``world`` ranks, this process's ``rank``, its
    ``device``, the process ``group`` (None at world 1) and whether each
    rank is fed its own rows (``process_local``: the multi-host feed)
    rather than every rank the global batch."""

    world: int = 1
    rank: int = 0
    device: Optional[torch.device] = None
    group: Any = None
    process_local: bool = False

    def rows(self, x):
        """This rank's rows ``[r B / W, (r + 1) B / W)`` of a global
        batch's array or tensor ``x`` (``x`` itself at world 1)."""
        if self.world == 1:
            return x
        if x.shape[0] % self.world:
            raise ValueError(f"a batch of {x.shape[0]} rows does not "
                             f"split over {self.world} ranks")
        n = x.shape[0] // self.world
        return x[self.rank * n:(self.rank + 1) * n]

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self.group)

    def decide(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank."""
        if self.world == 1:
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        dist.broadcast(t, src=0, group=self.group)
        return bool(t.item())


def make_mesh(num_devices: int = 0, device="cuda",
              process_local: bool = False) -> Mesh:
    """The data mesh on ``device`` (the card unless the caller asks for
    the CPU; without a card ``cuda`` raises) over the process group that
    is up. ``num_devices`` 0 takes its size (1 when no group is up);
    another value must equal it, and a value above 1 with no group up
    raises with how to launch."""
    from lisec_tpu_torch.pipelines.base import resolve_device
    device = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_devices > 1 and not dist.is_initialized():
        raise RuntimeError(
            f"train.num_devices={num_devices} but no process group is up: "
            + _LAUNCH_HINT.format(w=num_devices))
    if num_devices and num_devices != world:
        raise RuntimeError(
            f"train.num_devices={num_devices} but the process group has "
            f"{world} ranks (train.num_devices=0 takes the group's size)")
    if world == 1:
        return Mesh(device=device)
    return Mesh(world=world, rank=dist.get_rank(), device=device,
                group=dist.group.WORLD, process_local=process_local)


def shard_batch(batch: Dict[str, Any], mesh: Mesh
                ) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays or tensors) on this rank's device: its
    rows of the global batch, or all of a process-local batch."""
    return {k: torch.as_tensor(v if mesh.process_local else mesh.rows(v),
                               device=mesh.device)
            for k, v in batch.items()}


# -- the active mesh and its collectives -------------------------------------

_SINGLE = Mesh()
_ACTIVE: contextvars.ContextVar[Mesh] = contextvars.ContextVar(
    "lisec_tpu_torch_mesh", default=_SINGLE)


@contextlib.contextmanager
def use_mesh(mesh: Mesh) -> Iterator[Mesh]:
    """Make the helpers below reduce over ``mesh`` inside the block (a
    context variable, restored on exit)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def current_mesh() -> Mesh:
    """The mesh of the innermost ``use_mesh`` (world 1 outside one)."""
    return _ACTIVE.get()


class _AllReduceSum(torch.autograd.Function):
    """SUM over ranks; its backward is the SUM over ranks of the
    cotangents (see the module's docstring for why that is the gradient
    of the ranks' summed loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` stacked in rank order, by an ``all_reduce``
    SUM into a zero buffer; the backward sums the cotangents over ranks
    and keeps this rank's slot."""

    @staticmethod
    def forward(ctx, x, world, rank, group):
        ctx.rank, ctx.group = rank, group
        buf = x.new_zeros((world, *x.shape))
        buf[rank] = x
        dist.all_reduce(buf, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank], None, None, None


def world_size() -> int:
    return current_mesh().world


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, with autograd."""
    mesh = current_mesh()
    if mesh.world == 1:
        return x
    return _AllReduceSum.apply(x, mesh.group)


def global_mean(xs: Sequence[torch.Tensor], dim: Sequence[int]
                ) -> List[torch.Tensor]:
    """The mean of each of ``xs`` (tensors of one shape, the same on
    every rank) over ``dim`` and over every rank's: ``x.mean(dim)`` at
    world 1, else their sums in one ``all_reduce``."""
    mesh = current_mesh()
    if mesh.world == 1:
        return [x.mean(dim=dim) for x in xs]
    count = mesh.world
    for d in dim:
        count *= xs[0].shape[d]
    return list(global_sum(torch.stack([x.sum(dim=dim) for x in xs]))
                / count)


def mean_share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of the elements of every rank's
    ``x`` (all of one shape): summed over the ranks, that mean.
    ``x.mean()`` at world 1."""
    mesh = current_mesh()
    if mesh.world == 1:
        return x.mean()
    return x.sum() / (x.numel() * mesh.world)


def share(x: torch.Tensor) -> torch.Tensor:
    """1/W of a term every rank computes whole (from gathered inputs)."""
    mesh = current_mesh()
    return x if mesh.world == 1 else x / mesh.world


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (all of one shape) concatenated along dim 0 in
    rank order, with autograd; bool tensors travel as uint8."""
    mesh = current_mesh()
    if mesh.world == 1:
        return x
    if x.dtype == torch.bool:
        return all_gather(x.to(torch.uint8)).bool()
    buf = _AllGather.apply(x.contiguous(), mesh.world, mesh.rank, mesh.group)
    return buf.reshape(mesh.world * x.shape[0], *x.shape[1:])


def global_metrics(aux: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each rank's shares of 0-dim metrics summed over the ranks, in one
    ``all_reduce`` (``aux`` itself at world 1)."""
    if current_mesh().world == 1:
        return aux
    dtype = torch.float32
    for v in aux.values():
        dtype = torch.promote_types(dtype, v.dtype)
    total = global_sum(torch.stack([v.detach().to(dtype)
                                    for v in aux.values()]))
    return {k: t.to(v.dtype) for (k, v), t in zip(aux.items(),
                                                   total.unbind())}


@torch.no_grad()
def all_reduce_grads(params: Sequence[torch.nn.Parameter], mesh: Mesh
                     ) -> None:
    """Sum the parameters' ``.grad`` over the ranks in one flat bucket.
    Every rank runs one program, so the same parameters have a
    gradient on every rank."""
    if mesh.world == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


# -- local ranks --------------------------------------------------------------

def _rank_main(rank: int, world: int, device: str, tmp: str, fn,
               args) -> None:
    initialize_distributed(f"file://{os.path.join(tmp, 'rendezvous')}",
                           world, rank, backend="gloo", device=device)
    try:
        torch.save(fn(*args), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, device="cuda") -> List[Any]:
    """``fn(*args)`` in ``world`` new processes that form one gloo process
    group (a ``file://`` rendezvous in a temporary directory, so that
    concurrent groups cannot collide on a port); returns the results by
    rank. The ranks run on the card (rank r on card r modulo the cards
    it sees, so on a one-card machine they share it) unless the caller
    asks for the CPU; without a card ``cuda`` raises. ``fn`` must be importable by
    name; a rank that raises makes this raise, after the other ranks are
    stopped."""
    import torch.multiprocessing as mp
    from lisec_tpu_torch.pipelines.base import resolve_device
    device = str(resolve_device(device))
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(world, device, tmp, fn, args),
                 nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
