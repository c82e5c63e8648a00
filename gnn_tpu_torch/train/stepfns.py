"""The counterpart of `gnn_tpu.train.stepfns`: moving a host minibatch
to the device, rebuilding its adjacencies, the per-rank gradient clip and
the sum of the clipped gradients across ranks. The per-step recipe itself
(forward -> masked loss -> backward -> clip at 5 on each rank -> sum
across ranks -> Adam) lives in `gnn_tpu_torch.train.trainer.Trainer`.
``shard_map`` has no counterpart here: PyTorch runs one process per
rank; the jitted ``lax.scan`` of G steps is a CUDA graph replay
(`gnn_tpu_torch.train.dispatch`). On the ``data x part`` grid the sum spans every
rank and is scaled by ``1 / parts`` (`gnn_tpu_torch.parallel.dist.
grid_gradient_sum_`)."""
from __future__ import annotations

import dataclasses
from typing import Iterable, List

import torch

from gnn_tpu_torch.ops.sparse import to_device
from gnn_tpu_torch.sampling.ladies import MiniBatch


@dataclasses.dataclass
class DeviceBatch:
    """The device-side slice of a :class:`MiniBatch`."""

    # per-layer COOAdj | BlockedAdj | PatternAdj | ResidentLayerRef | None
    adjs: list
    sampled_nodes: list         # int32 [R_cap_l] per layer
    input_nodes: torch.Tensor   # int32 [C_cap_0]
    input_mask: torch.Tensor    # f32 [C_cap_0]
    labels: torch.Tensor        # f32 [B_cap, C]
    label_mask: torch.Tensor    # f32 [B_cap]
    # the feature source's routing of this batch's input rows (None for a
    # replicated table)
    feat_plan: object = None


def to_device_batch(mb: MiniBatch, device,
                    feature_source=None) -> DeviceBatch:
    """Copy a host batch to ``device``: every adjacency's numpy arrays
    become tensors of the same dtype (int16 cols stay int16), its counts
    0-d int64 tensors on ``device`` and its shapes Python ints
    (`gnn_tpu_torch.ops.sparse.to_device`: a CUDA graph replays what a
    tensor holds but bakes an int in). An adjacency object that several
    layers share (the subgraph sampler's square layer) is copied once and
    stays shared. With a ``feature_source``, the batch carries its
    plan."""
    def t(a):
        return torch.from_numpy(a).to(device)
    moved = {}
    adjs = []
    for a in mb.adjs:
        if id(a) not in moved:
            moved[id(a)] = to_device(a, device)
        adjs.append(moved[id(a)])
    return DeviceBatch(
        adjs=adjs,
        sampled_nodes=[t(s) for s in mb.sampled_nodes],
        input_nodes=t(mb.input_nodes), input_mask=t(mb.input_mask),
        labels=t(mb.labels), label_mask=t(mb.label_mask),
        feat_plan=(None if feature_source is None
                   else feature_source.plan(mb)))


def prepare_adjs(batch: DeviceBatch, agg_state) -> List[object]:
    """The batch's adjacency list. ``agg_state`` is the device-resident
    aggregation state: a ``ResidentGraph`` or this part's
    ``ShardedResidentGraph`` (resident mode: every layer is rebuilt from
    it), the hot blocks ``(dense, dense_t)`` (hot format:
    bound into the shipped layers), or None (COO, blocked, pattern: as
    shipped)."""
    from gnn_tpu_torch.ops.residentgraph import ResidentGraph
    from gnn_tpu_torch.parallel.shardedresident import ShardedResidentGraph
    if isinstance(agg_state, (ResidentGraph, ShardedResidentGraph)):
        from gnn_tpu_torch.ops.residentgraph import materialize_adjs
        return materialize_adjs(agg_state, batch.adjs,
                                batch.sampled_nodes, batch.input_nodes)
    if agg_state is not None:
        from gnn_tpu_torch.ops.hotdense import bind_dense
        return bind_dense(list(batch.adjs), *agg_state)
    return list(batch.adjs)


def clip_by_global_norm(params: Iterable[torch.nn.Parameter],
                        max_norm: float) -> torch.Tensor:
    """Scale gradients by ``min(1, max_norm / (norm + 1e-6))``
    (reference ``main.py:146``); returns the global norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(scale)
    return norm


def sum_gradients_(params: Iterable[torch.nn.Parameter],
                   extra: List[torch.Tensor], ctx) -> None:
    """Sum every parameter's gradient, and the ``extra`` tensors, across
    the ranks in place, with one ``all_reduce`` over one flat buffer
    (`gnn_tpu.train.stepfns`' ``psum``; the reference sums without
    dividing, ``main.py:159``); on a grid of part ranks, the sum over
    data ranks of the mean over part ranks. A parameter without a
    gradient on this rank takes zeros, so every rank packs the same
    buffer."""
    from gnn_tpu_torch.parallel.dist import grid_gradient_sum_
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    grid_gradient_sum_(grads + list(extra), ctx)
