"""Device-resident input features: the counterpart of
`gnn_tpu.parallel.feature_cache`.

:class:`ReplicatedFeatures` keeps the whole feature table on every
rank's device. :class:`CachedFeatures` (``--feature_cache``) keeps on
rank r only buffer r of the placement, and fetches a batch's other input
rows from the peers that hold them or from host RAM (reference
``main.py:129-134``, ``preprocess.py:397-399``). On the ``data x part``
grid (``--resident_parts P``) the part ranks of a data group share one
batch: :class:`PartShardedFeatures` shards the table by node ranges over
them, and :class:`PartCachedFeatures` (``--resident_parts
--feature_cache``) gives part p buffer p of a placement over P buffers.
A gather there is a masked local take plus one sum over the part group:
every row has one owner, so the sum is the gather. The sum moves the
whole ``[C, F]`` block, as the JAX package's ``psum`` does; an
all-to-all of exactly the owned rows would be a design of its own.

Both expose the trainer's three calls: ``plan(mb)`` on the host batch,
``gather(input_nodes, input_mask, plan)`` on the device batch (the
training step and the sharded test sweep; under the cache every rank
calls it at the same point, since it exchanges rows), and
``host_gather(input_nodes, input_mask)`` for the val pass, which every
rank runs alone on the same batch. Each returns float32 ``x [C, F]``
equal to ``feats[input_nodes] * input_mask[:, None]`` (with the table
rounded to ``dtype`` first): the sources move rows and compute nothing.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from gnn_tpu_torch.parallel.dist import DistContext, PartGroup, part_sum_
from gnn_tpu_torch.utils.timing import spanned


def _host_table(feats: np.ndarray, dtype, on_card: bool) -> torch.Tensor:
    """The table in host RAM, rounded to ``dtype`` (pinned for a card)."""
    host = torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(
        dtype)
    return host.pin_memory() if on_card else host


def _host_rows(host: torch.Tensor, nodes: np.ndarray,
               on_card: bool) -> torch.Tensor:
    """``host[nodes]``, pinned for a card (copied without blocking)."""
    rows = torch.empty((len(nodes), host.shape[1]), dtype=host.dtype,
                       pin_memory=on_card)
    torch.index_select(host, 0, torch.from_numpy(nodes), out=rows)
    return rows


def _host_gather(host: torch.Tensor, input_nodes: np.ndarray,
                 input_mask: np.ndarray, device) -> torch.Tensor:
    """float32 ``host[input_nodes] * input_mask[:, None]`` on ``device``."""
    rows = host.index_select(
        0, torch.from_numpy(np.asarray(input_nodes, np.int64)))
    return (rows.to(device).float()
            * torch.from_numpy(input_mask).to(device)[:, None])


class ReplicatedFeatures:
    """Whole feature table resident on ``device``. ``dtype`` bfloat16
    halves its memory and gather bytes; rows are cast back to float32
    right after the gather."""

    @spanned("setup.features")
    def __init__(self, feats: np.ndarray, dtype=torch.float32,
                 device="cpu"):
        self.dtype = dtype
        self.table = torch.from_numpy(
            np.ascontiguousarray(feats, np.float32)).to(device).to(dtype)

    def plan(self, mb) -> None:
        return None

    def gather(self, input_nodes: torch.Tensor, input_mask: torch.Tensor,
               plan=None) -> torch.Tensor:
        x = self.table.index_select(0, input_nodes.long()).float()
        return x * input_mask[:, None]

    def host_gather(self, input_nodes: np.ndarray,
                    input_mask: np.ndarray) -> torch.Tensor:
        dev = self.table.device
        return self.gather(torch.from_numpy(input_nodes).to(dev),
                           torch.from_numpy(input_mask).to(dev))


@dataclasses.dataclass
class CachePlan:
    """One batch's routing on one rank, built on the host. Positions are
    rows of the batch's ``x``; slots are rows of an owner's buffer."""

    req_counts: List[int]       # rows asked of each rank (0 for itself)
    req_slots: torch.Tensor     # int64 [sum(req_counts)], by owner
    remote_pos: torch.Tensor    # int64, where those rows land, same order
    local_slots: torch.Tensor   # int64, rows of this rank's own buffer
    local_pos: torch.Tensor
    host_rows: torch.Tensor     # dtype [H, F], rows held by no device
    host_pos: torch.Tensor


class CachedFeatures:
    """Placement-driven sharded cache with a host fallback
    (``--feature_cache``). Rank r holds buffer r of ``placement``
    (``placement.num_devs`` must be the world size, or the size of the
    group ``part``) on its device; the whole table stays in host RAM,
    pinned on a card.

    In the hybrid DP x cache mode the exchange runs over ``part``, a
    group of ``placement.num_devs`` ranks (:attr:`DistContext.cache_part`):
    rank ``r`` holds buffer ``part.rank`` (``r % P``) and owners are ranks
    of that group; without ``part`` the group is the whole world.

    Per batch, on the host (:meth:`plan`): each valid input row's owner
    and slot from ``placement.device_id_of_nodes[r]`` /
    ``idx_of_nodes_on_device[r]``, grouped by owner with one stable
    argsort (masked rows: owner -2, host rows: -1), as the JAX plan
    does; the host rows are gathered from the table and copied to the
    device without blocking. On the device (:meth:`gather`): one
    ``all_to_all_single`` of the per-owner counts and one of the slot
    ids (on :attr:`DistContext.meta_device`); each owner serves its
    requests with ``index_select`` and one ``all_to_all_single`` of
    exactly those rows returns them (the JAX ``all_to_all`` pads each
    plan to a bucket; counts make padding unnecessary here). Own rows
    are read locally. ``index_copy_`` places the three parts in ``x``,
    the input mask follows, and bfloat16 rows become float32 last.

    ``stats`` counts, over the batches planned, the valid input rows
    read from the rank's own buffer, from peers and from the host."""

    def __init__(self, feats: np.ndarray, placement, ctx: DistContext,
                 dtype=torch.float32, part: Optional[PartGroup] = None):
        if part is None:
            part = PartGroup(ctx.rank, ctx.world_size, ctx.group)
        if placement.num_devs != part.size:
            raise ValueError(
                f"the placement has {placement.num_devs} buffers for "
                f"{ctx.world_size} ranks"
                + (f" in groups of {part.size}"
                   if part.size != ctx.world_size else ""))
        self.ctx = ctx
        self.part = part
        self.dtype = dtype
        self.device = ctx.device
        self.on_card = self.device.type == "cuda"
        self.host = _host_table(feats, dtype, self.on_card)
        r = part.rank
        own = torch.from_numpy(np.asarray(placement.buffers[r], np.int64))
        self.buffer = self.host.index_select(0, own).to(self.device)
        self.owner = np.asarray(placement.device_id_of_nodes[r], np.int64)
        self.slot = np.asarray(placement.idx_of_nodes_on_device[r],
                               np.int64)
        self.row_bytes = self.buffer.shape[1] * self.buffer.element_size()
        self.stats = collections.Counter()

    def plan(self, mb) -> CachePlan:
        ws, r = self.part.size, self.part.rank
        nodes = np.asarray(mb.input_nodes, np.int64)
        owner = np.where(np.asarray(mb.input_mask) > 0, self.owner[nodes],
                         -2)
        order = np.argsort(owner, kind="stable")
        counts = np.bincount(owner + 2, minlength=ws + 2)
        bounds = np.concatenate([[0], np.cumsum(counts)])

        def part(o):      # input positions owned by o (-2, -1, 0..ws-1)
            return order[bounds[o + 2]: bounds[o + 3]]

        def t(a, device):
            return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
                device, non_blocking=True)

        dev, meta = self.device, self.ctx.meta_device
        peers = [o for o in range(ws) if o != r]
        remote = (np.concatenate([part(o) for o in peers]) if peers
                  else np.zeros(0, np.int64))
        host_pos = part(-1)
        host_rows = _host_rows(self.host, nodes[host_pos], self.on_card)
        req_counts = [0 if o == r else int(counts[o + 2]) for o in range(ws)]
        self.stats["batches"] += 1
        self.stats["rows_local"] += int(counts[r + 2])
        self.stats["rows_peer"] += sum(req_counts)
        self.stats["rows_host"] += int(counts[1])
        return CachePlan(
            req_counts=req_counts,
            req_slots=t(self.slot[nodes[remote]], meta),
            remote_pos=t(remote, dev),
            local_slots=t(self.slot[nodes[part(r)]], dev),
            local_pos=t(part(r), dev),
            host_rows=host_rows.to(dev, non_blocking=True),
            host_pos=t(host_pos, dev))

    def _exchange(self, plan: CachePlan) -> torch.Tensor:
        """The rows this rank asked its peers for, in ``req_slots``
        order, served by their owners."""
        meta, group = self.ctx.meta_device, self.part.group
        send = torch.tensor(plan.req_counts, dtype=torch.int64, device=meta)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        serve_counts = recv.tolist()
        slots = torch.empty(sum(serve_counts), dtype=torch.int64,
                            device=meta)
        dist.all_to_all_single(slots, plan.req_slots,
                               output_split_sizes=serve_counts,
                               input_split_sizes=plan.req_counts,
                               group=group)
        served = self.buffer.index_select(0, slots.to(self.device))
        rows = torch.empty((sum(plan.req_counts), self.buffer.shape[1]),
                           dtype=self.dtype, device=self.device)
        dist.all_to_all_single(rows, served,
                               output_split_sizes=plan.req_counts,
                               input_split_sizes=serve_counts, group=group)
        return rows

    def gather(self, input_nodes: torch.Tensor, input_mask: torch.Tensor,
               plan: CachePlan) -> torch.Tensor:
        if plan is None:
            raise ValueError("CachedFeatures.gather needs the batch's plan")
        x = torch.zeros((input_nodes.shape[0], self.buffer.shape[1]),
                        dtype=torch.float32, device=self.device)
        if self.part.size > 1:
            x.index_copy_(0, plan.remote_pos, self._exchange(plan).float())
        x.index_copy_(0, plan.local_pos,
                      self.buffer.index_select(0, plan.local_slots).float())
        x.index_copy_(0, plan.host_pos, plan.host_rows.float())
        return x * input_mask[:, None]

    def host_gather(self, input_nodes: np.ndarray,
                    input_mask: np.ndarray) -> torch.Tensor:
        return _host_gather(self.host, input_nodes, input_mask, self.device)


class PartShardedFeatures:
    """The table sharded by node ranges over the part group
    (``--resident_parts`` without ``--feature_cache``): part p holds
    rows ``[p * nsh, (p + 1) * nsh)`` on its device. A gather is the
    masked take of the owned rows plus one sum over the part group; no
    plan and no host rows. ``stats`` counts, over the batches planned,
    the valid input rows of the own range (``rows_local``) and of the
    other parts' (``rows_peer``)."""

    def __init__(self, feats: np.ndarray, part: PartGroup,
                 dtype=torch.float32, device="cpu"):
        self.part, self.dtype = part, dtype
        self.device = torch.device(device)
        self.host = _host_table(feats, dtype, False)
        n = feats.shape[0]
        self.nsh = -(-n // part.size)
        self.lo = part.rank * self.nsh
        shard = torch.zeros((self.nsh, feats.shape[1]), dtype=dtype)
        rows = self.host[self.lo:self.lo + self.nsh]
        shard[: rows.shape[0]] = rows
        self.table = shard.to(self.device)
        self.stats = collections.Counter()

    def plan(self, mb) -> None:
        nodes = np.asarray(mb.input_nodes, np.int64)
        valid = np.asarray(mb.input_mask) > 0
        own = valid & (nodes // self.nsh == self.part.rank)
        self.stats["batches"] += 1
        self.stats["rows_local"] += int(own.sum())
        self.stats["rows_peer"] += int(valid.sum() - own.sum())
        return None

    def gather(self, input_nodes: torch.Tensor, input_mask: torch.Tensor,
               plan=None) -> torch.Tensor:
        loc = input_nodes.long() - self.lo
        ok = (loc >= 0) & (loc < self.nsh)
        rows = self.table.index_select(0, loc.clamp(0, self.nsh - 1))
        x = torch.where(ok[:, None], rows.float(),
                        torch.zeros((), device=rows.device))
        part_sum_([x], self.part)
        return x * input_mask[:, None]

    def host_gather(self, input_nodes: np.ndarray,
                    input_mask: np.ndarray) -> torch.Tensor:
        return _host_gather(self.host, input_nodes, input_mask, self.device)


@dataclasses.dataclass
class PartCachePlan:
    """One batch's routing on one part rank, built on the host: the rows
    of its own buffer (slots, and positions in ``x``) and the host rows."""

    local_slots: torch.Tensor   # int64
    local_pos: torch.Tensor     # int64
    host_rows: torch.Tensor     # dtype [H, F], rows held by no part
    host_pos: torch.Tensor      # int64


class PartCachedFeatures:
    """The placement-driven cache composed with the part-sharded resident
    state (``--resident_parts --feature_cache``): part p holds buffer p
    of ``placement`` (``placement.num_devs`` must be the part count).

    A placement may hold a node on several devices (greedy's top block)
    or record it only in its owner's view (PaGraph), so ownership comes
    from a canonical map made at set-up: the first device whose own view
    holds the node locally. Under it every buffered node has exactly one
    owner, and the sum over the part group is the gather. Per batch, on
    the host (:meth:`plan`): the positions and slots of the rows this
    part owns and the rows no part holds (gathered from the host table);
    on the device (:meth:`gather`): the owned rows taken from the buffer
    into a zero block, one sum over the part group, the host rows written
    over it, the input mask last (bfloat16 rows become float32 right
    after the take). ``stats`` counts, over the batches planned, the
    valid input rows from this part's buffer, the other parts' and the
    host."""

    def __init__(self, feats: np.ndarray, placement, part: PartGroup,
                 dtype=torch.float32, device="cpu"):
        if placement.num_devs != part.size:
            raise ValueError(f"the placement has {placement.num_devs} "
                             f"buffers for {part.size} parts")
        self.part, self.dtype = part, dtype
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.host = _host_table(feats, dtype, self.on_card)
        own = torch.from_numpy(np.asarray(placement.buffers[part.rank],
                                          np.int64))
        self.buffer = self.host.index_select(0, own).to(self.device)
        did = np.asarray(placement.device_id_of_nodes)
        n = did.shape[1]
        local = did == np.arange(placement.num_devs)[:, None]
        self.owner_map = np.where(local.any(axis=0),
                                  np.argmax(local, axis=0), -1)
        self.slot_map = np.asarray(placement.idx_of_nodes_on_device)[
            np.maximum(self.owner_map, 0), np.arange(n)].astype(np.int64)
        self.row_bytes = self.buffer.shape[1] * self.buffer.element_size()
        self.stats = collections.Counter()

    def plan(self, mb) -> PartCachePlan:
        nodes = np.asarray(mb.input_nodes, np.int64)
        owner = np.where(np.asarray(mb.input_mask) > 0,
                         self.owner_map[nodes], -2)
        local = np.flatnonzero(owner == self.part.rank)
        host_pos = np.flatnonzero(owner == -1)
        host_rows = _host_rows(self.host, nodes[host_pos], self.on_card)
        self.stats["batches"] += 1
        self.stats["rows_local"] += len(local)
        self.stats["rows_peer"] += int((owner >= 0).sum()) - len(local)
        self.stats["rows_host"] += len(host_pos)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
                self.device, non_blocking=True)
        return PartCachePlan(
            local_slots=t(self.slot_map[nodes[local]]), local_pos=t(local),
            host_rows=host_rows.to(self.device, non_blocking=True),
            host_pos=t(host_pos))

    def gather(self, input_nodes: torch.Tensor, input_mask: torch.Tensor,
               plan: PartCachePlan) -> torch.Tensor:
        if plan is None:
            raise ValueError("PartCachedFeatures.gather needs the batch's "
                             "plan")
        x = torch.zeros((input_nodes.shape[0], self.buffer.shape[1]),
                        dtype=torch.float32, device=self.device)
        x.index_copy_(0, plan.local_pos,
                      self.buffer.index_select(0, plan.local_slots).float())
        part_sum_([x], self.part)
        x.index_copy_(0, plan.host_pos, plan.host_rows.float())
        return x * input_mask[:, None]

    def host_gather(self, input_nodes: np.ndarray,
                    input_mask: np.ndarray) -> torch.Tensor:
        return _host_gather(self.host, input_nodes, input_mask, self.device)
