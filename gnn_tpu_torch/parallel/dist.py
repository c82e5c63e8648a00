"""Data parallelism over ``torch.distributed``: the counterpart of
`gnn_tpu.parallel.mesh` (a mesh with one ``data`` axis).

One process per rank. :func:`spawn_ranks` starts ``n`` of them from one
command (``torch.multiprocessing`` with the ``spawn`` method, a
``FileStore`` rendezvous in a directory the caller names); under
``torchrun`` :func:`init_dist_from_env` takes the rank and world size
from the environment instead. Every rendezvous and collective waits at
most ``COLLECTIVE_TIMEOUT_S`` and the launcher's join ``JOIN_TIMEOUT_S``
(both read at call time), so a hung rank fails the run rather than
hanging it.

Backends and devices are chosen in the open (:func:`resolve_backend`,
:func:`rank_device`): on ``cpu`` gloo; on ``cuda`` NCCL by default, with
rank r on ``cuda:r``, refused before any rank starts when there are more
ranks than cards (NCCL will not put two ranks on one device); with
``backend="gloo"`` ranks may share cards (rank r on ``cuda:(r % cards)``)
and only the collectives go through gloo. Gloo takes CUDA tensors for
``all_reduce`` and ``all_to_all_single`` (it stages them through the
host itself); the small host-made index tensors of the feature cache
travel on :attr:`DistContext.meta_device`, the CPU under gloo.

A world of one rank is a :class:`DistContext` with no process group; its
helpers return their inputs unchanged, so one device keeps its exact
numbers.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
import uuid
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# the longest a rendezvous or a collective waits for the other ranks (rank
# 0's set-up of a large graph holds the others at a barrier for minutes)
COLLECTIVE_TIMEOUT_S = 1800.0
# the longest the launcher waits for its ranks to finish
JOIN_TIMEOUT_S = 7 * 24 * 3600.0
BACKENDS = ("auto", "nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class DistContext:
    """Where this process stands among the ranks. ``backend`` is None for
    a world of one (no process group)."""

    rank: int = 0
    world_size: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    group: object = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def meta_device(self) -> torch.device:
        """Where host-made collective operands (counts, slot ids, scalars)
        live: the rank's card under NCCL, which takes nothing else; the
        CPU under gloo and in a world of one."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def barrier(self) -> None:
        if self.world_size == 1:
            return
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


@dataclasses.dataclass(frozen=True)
class Rendezvous:
    """What a spawned rank needs to join its group."""

    world_size: int
    init_method: str
    timeout_s: float


def resolve_backend(device_type: str, requested: str,
                    world_size: int) -> str:
    """The backend of ``world_size`` ranks on ``device_type``: ``auto``
    is gloo on ``cpu`` and NCCL on ``cuda``. Raises where the request
    cannot run: NCCL on the CPU, or NCCL with more ranks than cards."""
    if requested not in BACKENDS:
        raise ValueError(f"unknown backend {requested!r}; one of {BACKENDS}")
    if device_type == "cpu":
        if requested == "nccl":
            raise ValueError("NCCL runs on CUDA devices only; CPU ranks "
                             "use gloo (--dist_backend gloo or auto)")
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    backend = "nccl" if requested == "auto" else requested
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(
                f"NCCL runs one rank per card, and {world_size} ranks on "
                f"{cards} card(s) would put two on one device, which NCCL "
                f"refuses; pass --dist_backend gloo to let ranks share a "
                f"card")
    return backend


def rank_device(device_type: str, backend: str, rank: int) -> torch.device:
    """Rank ``rank``'s device: the CPU, ``cuda:rank`` under NCCL, or
    ``cuda:(rank % cards)`` under gloo (ranks may share a card)."""
    if device_type == "cpu":
        return torch.device("cpu")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("CUDA was asked for but no card is visible")
    return torch.device("cuda", rank if backend == "nccl" else rank % cards)


def _join_group(rank: int, world_size: int, device_type: str, backend: str,
                init_method: str, timeout_s: float) -> DistContext:
    from gnn_tpu_torch.device import resolve_device
    device = resolve_device(rank_device(device_type, backend, rank))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return DistContext(rank, world_size, device, backend, dist.group.WORLD)


def init_dist(rank: int, rdv: Rendezvous, device_type: str,
              backend: str) -> DistContext:
    """Join the group of a rank started by :func:`spawn_ranks`."""
    return _join_group(rank, rdv.world_size, device_type, backend,
                       rdv.init_method, rdv.timeout_s)


def init_dist_from_env(device_type: str, requested: str) -> DistContext:
    """Join the group of a rank started by ``torchrun`` (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` in the
    environment)."""
    rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend = resolve_backend(device_type, requested, world_size)
    return _join_group(rank, world_size, device_type, backend, "env://",
                       COLLECTIVE_TIMEOUT_S)


def close_dist(ctx: DistContext) -> None:
    if ctx.world_size > 1 and dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank: int, fn: Callable, rdv: Rendezvous, args: tuple):
    fn(rank, rdv, *args)


def spawn_ranks(n: int, fn: Callable, args: Sequence = (),
                rendezvous_dir: str = ".") -> None:
    """Run ``fn(rank, rendezvous, *args)`` in ``n`` new processes and wait
    for all of them. ``fn`` must be importable by name (the ``spawn``
    method imports its module afresh) and joins its group with
    :func:`init_dist`. The rendezvous is a ``FileStore`` file, unique to
    this call, in ``rendezvous_dir``; no port is opened. If one rank
    fails, the others are stopped and its error raised; if they run past
    ``JOIN_TIMEOUT_S``, all are stopped and ``TimeoutError`` raised."""
    import torch.multiprocessing as mp

    os.makedirs(rendezvous_dir, exist_ok=True)
    store = os.path.abspath(os.path.join(
        rendezvous_dir, f".rendezvous-{uuid.uuid4().hex}"))
    rdv = Rendezvous(n, f"file://{store}", COLLECTIVE_TIMEOUT_S)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    procs = mp.start_processes(_rank_main, args=(fn, rdv, tuple(args)),
                               nprocs=n, join=False, start_method="spawn")
    try:
        while not procs.join(timeout=max(0.0, min(
                5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{n} ranks did not finish within "
                                   f"{JOIN_TIMEOUT_S:.0f} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        if os.path.exists(store):
            os.unlink(store)


def all_reduce_sum_(tensors: List[torch.Tensor], ctx: DistContext) -> None:
    """Sum each tensor across the ranks, in place, through one flat
    buffer and one ``all_reduce`` (the tensors share a dtype and device).
    A world of one leaves them untouched."""
    if ctx.world_size == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=ctx.group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def sum_across_ranks(values: Sequence[float],
                     ctx: DistContext) -> List[float]:
    """Each value summed across the ranks (float64)."""
    if ctx.world_size == 1:
        return list(values)
    t = torch.tensor(values, dtype=torch.float64, device=ctx.meta_device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=ctx.group)
    return t.tolist()


def mean_across_ranks(values: Sequence[float],
                      ctx: DistContext) -> List[float]:
    """Each value's mean across the ranks (float64)."""
    if ctx.world_size == 1:
        return list(values)
    return [v / ctx.world_size for v in sum_across_ranks(values, ctx)]


def broadcast_from_main(values: Sequence[float],
                        ctx: DistContext) -> List[float]:
    """Rank 0's values on every rank (float64): one decision, taken by
    rank 0, for all."""
    if ctx.world_size == 1:
        return list(values)
    t = torch.tensor(values, dtype=torch.float64, device=ctx.meta_device)
    dist.broadcast(t, src=0, group=ctx.group)
    return t.tolist()

