"""Data parallelism over ``torch.distributed``, and the ``data x part``
grid of ranks: the counterpart of `gnn_tpu.parallel.mesh` (a mesh with
one ``data`` axis) and of `gnn_tpu.parallel.multihost.make_hybrid_mesh`
(the ``(data, part)`` mesh of ``--resident_parts``).

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

The grid (``parts`` > 1): ``dp`` data ranks x ``parts`` part ranks, rank
``r = d * parts + p`` as the JAX mesh lays out ``devices.reshape(dp,
part)``. Every rank creates every data group (the ranks of one part
index, in ``p`` order) and then every part group (the ranks of one data
index, in ``d`` order) with ``dist.new_group(ranks, backend=...)``, the
same calls in the same order on every rank, as ``new_group`` requires;
the backend is named, never a ``DeviceMesh`` default (which picks NCCL
on ``cuda``, where ranks share the one card under gloo). A part group
holds the ranks that share one batch and shard the resident state:
:func:`part_sum_` and :func:`part_max_` reduce over it, inside the
forward and backward passes (`gnn_tpu_torch.parallel.shardedresident`).
Gloo takes int32 SUM and float MAX on CUDA tensors as it takes float
SUM (staging through the host itself), so these collectives need no
staging of their own. :func:`grid_gradient_sum_` sums the gradients over
the whole grid and scales them by ``1 / parts``: the sum over data ranks
of the mean over part ranks. That equals the JAX step (a sum over the
data axis of gradients the parts hold bit for bit alike) wherever the
parts agree, and leaves every rank with the same bits where they do not
(the card's kernels sum in a run-dependent order), since one collective
delivers the same sums to all.

The hybrid DP x cache mode (the JAX package's ``CachedFeatures(...,
axis=PART_AXIS, world_size=dp * P)``): :func:`hybrid_view` of a ``dp x
P`` grid context makes every rank a data rank with its own batch
(``parts`` 1, so the gradient sum is one plain ``all_reduce`` over the
whole world) and hands the grid's part groups to the feature cache
alone (``cache_parts`` P, :attr:`DistContext.cache_part`): it exchanges
rows inside groups of P consecutive ranks, and rank r reads buffer
``r % P``.
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import time
import uuid
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the longest a rendezvous or a collective waits for the other ranks (rank
# 0's set-up of a large graph holds the others at a barrier for minutes)
COLLECTIVE_TIMEOUT_S = 1800.0
# the longest the launcher waits for its ranks to finish
JOIN_TIMEOUT_S = 7 * 24 * 3600.0
BACKENDS = ("auto", "nccl", "gloo")

# bytes reduced over part groups ("sum", "max"); incremented only where
# a collective runs (the per-step figure of chip_smoke.py phase 8)
part_bytes: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class PartGroup:
    """This rank's place in its part group: ``rank`` of ``size`` part
    ranks, reduced over ``group``. One part (``size`` 1) reduces
    nothing."""

    rank: int = 0
    size: int = 1
    group: object = None

    def all_reduce_(self, t: torch.Tensor, op) -> None:
        dist.all_reduce(t, op=op, group=self.group)


@dataclasses.dataclass(frozen=True)
class DistContext:
    """Where this process stands among the ranks. ``backend`` is None for
    a world of one (no process group)."""

    rank: int = 0
    world_size: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    group: object = None
    # the grid: ``parts`` part ranks per data rank, and this rank's data
    # group (same part index) and part group (same data index); None
    # where the group would hold one rank
    parts: int = 1
    data_group: object = None
    part_group: object = None
    # the hybrid DP x cache mode (hybrid_view): the feature cache's
    # buffers sharded over groups of ``cache_parts`` consecutive ranks
    # (this rank's: ``cache_group``); only the cache exchanges over them
    cache_parts: int = 1
    cache_group: object = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def dp(self) -> int:
        return self.world_size // self.parts

    @property
    def data_rank(self) -> int:
        return self.rank // self.parts

    @property
    def part_rank(self) -> int:
        return self.rank % self.parts

    @property
    def part(self) -> PartGroup:
        return PartGroup(self.part_rank, self.parts, self.part_group)

    @property
    def cache_part(self) -> PartGroup:
        """This rank's place in its cache group: rank ``r`` reads buffer
        ``r % cache_parts``."""
        return PartGroup(self.rank % self.cache_parts, self.cache_parts,
                         self.cache_group)

    def data_view(self) -> "DistContext":
        """The data ranks of this rank's part index as a context of their
        own (rank ``data_rank`` of ``dp``): the pipeline's rank and world,
        and the scope of the test sweep's sums."""
        if self.parts == 1:
            return self
        return DistContext(self.data_rank, self.dp, self.device,
                           self.backend if self.dp > 1 else None,
                           self.data_group)

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


def _grid_groups(rank: int, world_size: int, parts: int, backend: str):
    """``(data_group, part_group)`` of ``rank`` on the ``dp x parts``
    grid; every rank makes every group, data groups first."""
    if world_size % parts:
        raise ValueError(f"{world_size} ranks do not split into "
                         f"{parts} parts")
    dp = world_size // parts
    data_group = part_group = None
    if dp > 1:
        for p in range(parts):
            g = dist.new_group([d * parts + p for d in range(dp)],
                               backend=backend)
            if p == rank % parts:
                data_group = g
    for d in range(dp):
        g = dist.new_group([d * parts + p for p in range(parts)],
                           backend=backend)
        if d == rank // parts:
            part_group = g
    return data_group, part_group


def _join_group(rank: int, world_size: int, device_type: str, backend: str,
                init_method: str, timeout_s: float,
                parts: int = 1) -> DistContext:
    from gnn_tpu_torch.device import resolve_device
    device = resolve_device(rank_device(device_type, backend, rank))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    data_group = part_group = None
    if parts > 1:
        data_group, part_group = _grid_groups(rank, world_size, parts,
                                              backend)
    return DistContext(rank, world_size, device, backend, dist.group.WORLD,
                       parts, data_group, part_group)


def init_dist(rank: int, rdv: Rendezvous, device_type: str,
              backend: str, parts: int = 1) -> DistContext:
    """Join the group of a rank started by :func:`spawn_ranks`, as rank
    ``rank`` of a ``world_size / parts`` x ``parts`` grid."""
    return _join_group(rank, rdv.world_size, device_type, backend,
                       rdv.init_method, rdv.timeout_s, parts)


def hybrid_view(ctx: DistContext) -> DistContext:
    """A grid context's ranks as the hybrid mode's: every rank a data
    rank of the whole world, the grid's part groups the cache's groups
    (the same ranks: one data index each)."""
    return dataclasses.replace(ctx, parts=1, data_group=None,
                               part_group=None, cache_parts=ctx.parts,
                               cache_group=ctx.part_group)


def process_local_rank_span(total: int, ctx: DistContext
                            ) -> Tuple[int, int]:
    """``[start, end)`` of ``total`` work items owned by this rank (one
    process a rank): host-side loading split over the ranks."""
    chunk = (total + ctx.world_size - 1) // ctx.world_size
    return ctx.rank * chunk, min((ctx.rank + 1) * chunk, total)


def init_dist_from_env(device_type: str, requested: str,
                       parts: int = 1) -> DistContext:
    """Join the group of a rank started by ``torchrun`` (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` in the
    environment)."""
    rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend = resolve_backend(device_type, requested, world_size)
    return _join_group(rank, world_size, device_type, backend, "env://",
                       COLLECTIVE_TIMEOUT_S, parts)


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


def part_sum_(tensors: List[torch.Tensor], part: Optional[PartGroup]
              ) -> None:
    """Sum each tensor over the part group, in place, through one
    ``all_reduce`` (one flat buffer where there are several; the tensors
    share a dtype and device). One part, or ``part`` None, leaves them
    untouched. Invisible to autograd: a caller that differentiates
    through it says how its cotangents combine."""
    if part is None or part.size == 1 or not tensors:
        return
    if len(tensors) == 1 and tensors[0].is_contiguous():
        flat = tensors[0]
    else:
        flat = torch.cat([t.reshape(-1) for t in tensors])
    part_bytes["sum"] += flat.numel() * flat.element_size()
    part.all_reduce_(flat, dist.ReduceOp.SUM)
    if flat is tensors[0]:
        return
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def part_max_(t: torch.Tensor, part: Optional[PartGroup]) -> None:
    """The elementwise max of a contiguous ``t`` over the part group, in
    place (``-inf`` entries stay unless another part has more)."""
    if part is None or part.size == 1:
        return
    part_bytes["max"] += t.numel() * t.element_size()
    part.all_reduce_(t, dist.ReduceOp.MAX)


def grid_gradient_sum_(tensors: List[torch.Tensor],
                       ctx: DistContext) -> None:
    """Sum each tensor over every rank of the grid and scale it by
    ``1 / parts``: the sum over data ranks of the mean over part ranks
    (one ``all_reduce``, so every rank ends with the same bits)."""
    all_reduce_sum_(tensors, ctx)
    if ctx.parts > 1:
        for t in tensors:
            t.mul_(1.0 / ctx.parts)


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

