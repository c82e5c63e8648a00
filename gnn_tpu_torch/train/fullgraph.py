"""Full-graph (non-sampled) distributed training over contiguous row
partitions: the counterpart of `gnn_tpu.train.fullgraph`.

One process is one partition. The model is the GCN layer recipe of
`gnn_tpu_torch.models.gnn` (``elu(A x W + b)``, then the per-row
LayerNorm; after the last layer the row-wise L2 normalisation and the
head), but each layer's aggregation is the halo-exchange SpMM of
`gnn_tpu_torch.parallel.halo`: a rank owns a row partition of the graph
and of every layer's activations, and one ``all_to_all`` a layer (and
one in its backward) moves the boundary rows.

A step keeps the JAX package's two semantics:

- the loss is normalised by the global train-node count (one
  ``all_reduce`` of the local mask sums, at set-up: the mask does not
  change), so each rank's loss is its partial sum and the reported loss
  is the sum over the ranks;
- the ranks' gradients are summed first, then clipped at 5 by their
  global norm, then Adam runs (the minibatch ``Trainer`` clips each
  rank's gradient before the sum).

A ``data x part`` grid context partitions over its whole world group,
as the JAX hybrid mesh partitions over its flattened axes.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch import nn

from gnn_tpu_torch.device import resolve_device
from gnn_tpu_torch.models.gnn import Dense, GraphConv, _row_layernorm
from gnn_tpu_torch.parallel.dist import DistContext, all_reduce_sum_
from gnn_tpu_torch.parallel.halo import (LocalHaloPlan, build_halo_plan,
                                         halo_spmm_local)
from gnn_tpu_torch.train.stepfns import clip_by_global_norm


class FullGraphGCN(nn.Module):
    """The full-graph GCN: ``gcs`` layers (`GraphConv`'s parameters:
    ``linear``, ``scale``, ``offset``; their aggregation is the caller's)
    and a linear ``head``."""

    def __init__(self, n_feats: int, nhid: int, orders: Sequence[int],
                 num_classes: int, generator=None):
        super().__init__()
        orders = tuple(int(o) for o in orders)
        widths = [n_feats] + [nhid] * len(orders)
        self.gcs = nn.ModuleList(
            GraphConv(widths[i], widths[i + 1], o, generator)
            for i, o in enumerate(orders))
        self.head = Dense(nhid, num_classes, generator)

    def forward(self, x: torch.Tensor, aggregate) -> torch.Tensor:
        return fullgraph_forward_local(self, x, aggregate)


def init_fullgraph_params(n_feats: int, nhid: int, orders: Sequence[int],
                          num_classes: int,
                          generator: Optional[torch.Generator] = None
                          ) -> FullGraphGCN:
    """A :class:`FullGraphGCN` with lecun-normal kernels drawn from
    ``generator`` (layer by layer, then the head), zero biases and
    offsets, unit scales."""
    return FullGraphGCN(n_feats, nhid, orders, num_classes, generator)


def _gcn_layer_local(layer: GraphConv, x: torch.Tensor, aggregate):
    feat = aggregate(x) if layer.order > 0 else x
    return _row_layernorm(F.elu(layer.linear(feat)), layer.scale,
                          layer.offset)


def fullgraph_forward_local(net: FullGraphGCN, x_local: torch.Tensor,
                            aggregate) -> torch.Tensor:
    """One rank's forward over its node partition; ``aggregate(z)`` is
    the layer's ``A @ z`` on the partition."""
    h = x_local
    for layer in net.gcs:
        h = _gcn_layer_local(layer, h, aggregate)
    norm = torch.sqrt((h * h).sum(dim=1, keepdim=True) + 1e-24)
    h = h / norm.clamp_min(1e-12)
    return net.head(h)


def _partial_loss(out, y, w, sigmoid_loss: bool) -> torch.Tensor:
    """This rank's share of the globally normalised loss (``w`` is the
    train mask over the global train-node count)."""
    if sigmoid_loss:
        per = (out.clamp_min(0) - out * y
               + torch.log1p(torch.exp(-out.abs())))
        return (per * w[:, None]).sum()
    logp = F.log_softmax(out, dim=1)
    return (-(y * logp).sum(dim=1) * w).sum()


class FullGraphTrainer:
    """Full-batch distributed GCN trainer: one rank of ``dist`` (one
    partition), or the whole graph on ``device`` (``cuda`` unless the
    caller passes ``cpu``) without ``dist``. Every rank builds the same
    plan from the whole graph and keeps its own row of it, of the
    features, labels and train mask. The weights come from
    :func:`init_fullgraph_params` seeded with ``seed``, the same on every
    rank."""

    def __init__(self, adj, feats: np.ndarray, labels_dense: np.ndarray,
                 train_mask: np.ndarray, orders: Sequence[int], nhid: int,
                 num_classes: int, lr: float = 0.01,
                 sigmoid_loss: bool = False, seed: int = 0,
                 dist: Optional[DistContext] = None, device="cuda"):
        if dist is None:
            dist = DistContext(device=resolve_device(device))
        self.dist = dist
        self.device = dist.device
        self.sigmoid_loss = sigmoid_loss
        D, r = dist.world_size, dist.rank
        t0 = time.perf_counter()
        self.plan, self.owner = build_halo_plan(adj, D)
        # the host plan's share of the set-up
        self.plan_seconds = time.perf_counter() - t0
        nl = self.plan.n_local
        self.local_plan = LocalHaloPlan.from_plan(self.plan, r, self.device)
        mine = np.flatnonzero(self.owner == r)

        def local(a, dtype):
            out = np.zeros((nl,) + a.shape[1:], dtype)
            out[: len(mine)] = a[mine]
            return torch.from_numpy(out).to(self.device)
        self.x = local(np.asarray(feats), np.float32)
        self.y = local(np.asarray(labels_dense), np.float32)
        self.mask = local(np.asarray(train_mask), np.float32)
        n_valid = self.mask.sum().reshape(1)
        all_reduce_sum_([n_valid], dist)
        self.n_valid = n_valid.clamp_min(1.0)

        self.net = init_fullgraph_params(
            self.x.shape[1], nhid, orders, num_classes,
            torch.Generator().manual_seed(seed)).to(self.device)
        self.optimizer = torch.optim.Adam(self.net.parameters(), lr=lr)

    def _aggregate(self, z: torch.Tensor) -> torch.Tensor:
        return halo_spmm_local(self.local_plan, z, self.dist)

    def local_loss(self) -> torch.Tensor:
        """This rank's partial loss (a differentiable scalar)."""
        out = self.net(self.x, self._aggregate)
        return _partial_loss(out, self.y, self.mask / self.n_valid,
                             self.sigmoid_loss)

    def train_step(self) -> float:
        """One step: backward of the partial loss, the gradients and the
        loss summed over the ranks (one ``all_reduce``), the clip at 5,
        Adam. Returns the summed loss."""
        loss = self.local_loss()
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = []
        for p in self.net.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        total = loss.detach().reshape(1).clone()
        all_reduce_sum_(grads + [total], self.dist)
        clip_by_global_norm(self.net.parameters(), 5.0)
        self.optimizer.step()
        return float(total[0])

    def train_steps(self, n: int) -> List[float]:
        return [self.train_step() for _ in range(n)]

    def predict(self) -> np.ndarray:
        """Every node's logits ``[N, C]`` in node order, on every rank
        (each partition's rows gathered from its owner)."""
        with torch.no_grad():
            out = self.net(self.x, self._aggregate)
        C = out.shape[1]
        if self.dist.world_size > 1:
            meta = self.dist.meta_device
            parts = [torch.empty_like(out, device=meta)
                     for _ in range(self.dist.world_size)]
            tdist.all_gather(parts, out.to(meta), group=self.dist.group)
            out = torch.stack(parts)
        else:
            out = out[None]
        out = out.cpu().numpy()
        full = np.zeros((len(self.owner), C), np.float32)
        for d in range(out.shape[0]):
            mine = np.flatnonzero(self.owner == d)
            full[mine] = out[d, : len(mine)]
        return full
