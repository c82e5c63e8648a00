"""GNN model family as ``torch.nn.Module``s: the counterpart of
`gnn_tpu.models.gnn` (reference ``models.py``); the GAT encoder lives in
`gnn_tpu_torch.models.gat`.

* :class:`SageConv` — ``concat([B(x[sampled]), W(A @ x)])`` for
  ``order > 0``, ``W(x)`` for ``order == 0``; ELU; per-row LayerNorm with
  biased variance + 1e-9 and learned ``scale``/``offset``.
* :class:`GraphConv` — ``elu(linear(A @ x))`` + the same LayerNorm.
* :class:`GINConv` — ``MLP((1 + eps) * x_self + A @ x)`` + LayerNorm.
* :class:`GNN` — encoder -> row-wise L2 normalize (``+1e-24`` inside the
  sqrt) -> dropout -> linear classifier.

Linear layers initialise as flax's ``Dense`` does: lecun-normal kernels
(truncated normal, variance 1/fan_in) and zero biases, drawn from an
explicit ``torch.Generator``. Dropout draws from the generator passed to
``forward``. Parameter names follow the flax tree (``gcs_{i}``,
``linearW``, ``linearB``, ``scale``, ...) so
`gnn_tpu_torch.weights.params_from_flax` maps one onto the other.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gnn_tpu_torch.ops.sparse import spmm

# stddev of a standard normal truncated to [-2, 2] (flax/JAX
# variance_scaling's correction constant)
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Linear):
    """``nn.Linear`` initialised like flax's ``nn.Dense``."""

    def __init__(self, n_in: int, n_out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(n_in, n_out)
        std = (1.0 / n_in) ** 0.5 / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
            self.bias.zero_()


def _row_layernorm(out, scale, offset):
    """Per-row LayerNorm: biased variance, eps added to var."""
    mean = out.mean(dim=1, keepdim=True)
    var = out.var(dim=1, unbiased=False, keepdim=True) + 1e-9
    return (out - mean) * scale * torch.rsqrt(var) + offset


def _dropout(x, p: float, training: bool,
             generator: Optional[torch.Generator]):
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep / (1.0 - p)


class SageConv(nn.Module):
    """GraphSAGE convolution (reference ``models.py:6-25``)."""

    def __init__(self, n_in: int, n_out: int, order: int, generator=None):
        super().__init__()
        self.order = order
        if order > 0:
            self.linearB = Dense(n_in, n_out, generator)
        self.linearW = Dense(n_in, n_out, generator)
        width = (1 + order) * n_out
        self.scale = nn.Parameter(torch.ones(width))
        self.offset = nn.Parameter(torch.zeros(width))

    def forward(self, x, adj, sampled_nodes):
        if self.order > 0:
            feat = spmm(adj, x)
            x_self = x.index_select(0, sampled_nodes.long())
            feat = torch.cat([self.linearB(x_self), self.linearW(feat)], 1)
        else:
            feat = self.linearW(x)
        return _row_layernorm(F.elu(feat), self.scale, self.offset)


class GraphConv(nn.Module):
    """GCN convolution (reference ``models.py:48-64``)."""

    def __init__(self, n_in: int, n_out: int, order: int, generator=None):
        super().__init__()
        self.order = order
        self.linear = Dense(n_in, n_out, generator)
        self.scale = nn.Parameter(torch.ones(n_out))
        self.offset = nn.Parameter(torch.zeros(n_out))

    def forward(self, x, adj, sampled_nodes=None):
        feat = spmm(adj, x) if self.order > 0 else x
        return _row_layernorm(F.elu(self.linear(feat)), self.scale,
                              self.offset)


class GINConv(nn.Module):
    """Graph Isomorphism Network layer with learnable ``eps``."""

    def __init__(self, n_in: int, n_out: int, order: int, generator=None):
        super().__init__()
        self.order = order
        if order > 0:
            self.eps = nn.Parameter(torch.zeros(()))
        self.mlp1 = Dense(n_in, n_out, generator)
        self.mlp2 = Dense(n_out, n_out, generator)
        self.scale = nn.Parameter(torch.ones(n_out))
        self.offset = nn.Parameter(torch.zeros(n_out))

    def forward(self, x, adj, sampled_nodes):
        if self.order > 0:
            agg = spmm(adj, x)
            x_self = x.index_select(0, sampled_nodes.long())
            feat = (1.0 + self.eps) * x_self + agg
        else:
            feat = x
        h = self.mlp2(F.relu(self.mlp1(feat)))
        return _row_layernorm(h, self.scale, self.offset)


class _Stack(nn.Module):
    """A stack of convolutions with dropout after every layer."""

    conv = None

    def __init__(self, n_in: int, nhid: int, orders: Sequence[int],
                 dropout: float = 0.1, generator=None):
        super().__init__()
        self.nhid = nhid
        self.orders = tuple(orders)
        self.dropout = dropout
        widths = self._in_widths(n_in)
        self.layers = nn.ModuleList(
            [type(self).conv(widths[i], nhid, o, generator)
             for i, o in enumerate(self.orders)])

    def _in_widths(self, n_in):
        return [n_in] + [self.nhid] * (len(self.orders) - 1)

    @property
    def out_dim(self) -> int:
        return self.nhid

    def forward(self, x, adjs, sampled_nodes, generator=None):
        for i, layer in enumerate(self.layers):
            x = layer(x, adjs[i], sampled_nodes[i])
            x = _dropout(x, self.dropout, self.training, generator)
        return x


class GraphSage(_Stack):
    """Stack of SageConv layers (reference ``models.py:27-44``); layer i
    consumes width ``(1 + orders[i-1]) * nhid``."""

    conv = SageConv

    def _in_widths(self, n_in):
        return [n_in] + [(1 + o) * self.nhid for o in self.orders[:-1]]

    @property
    def out_dim(self) -> int:
        return (1 + self.orders[-1]) * self.nhid


class GCN(_Stack):
    """Stack of GraphConv layers (reference ``models.py:67-84``)."""

    conv = GraphConv


class GIN(_Stack):
    """Stack of GINConv layers."""

    conv = GINConv


class GNN(nn.Module):
    """Encoder + classification head (reference ``models.py:86-97``)."""

    def __init__(self, encoder: _Stack, num_classes: int,
                 dropout: float = 0.1, generator=None):
        super().__init__()
        self.encoder = encoder
        self.dropout = dropout
        self.linear = Dense(encoder.out_dim, num_classes, generator)

    def forward(self, feat, adjs, sampled_nodes,
                generator: Optional[torch.Generator] = None):
        x = self.encoder(feat, adjs, sampled_nodes, generator)
        # row-wise L2 normalization; the 1e-24 keeps the sqrt gradient
        # finite on all-zero (padded) rows
        norm = torch.sqrt((x * x).sum(dim=1, keepdim=True) + 1e-24)
        x = x / norm.clamp_min(1e-12)
        x = _dropout(x, self.dropout, self.training, generator)
        return self.linear(x)


def build_model(model: str, nhid: int, orders: Sequence[int],
                num_classes: int, n_feats: int, dropout: float = 0.1,
                seed: int = 0) -> GNN:
    """Build the full model the way ``main.py:91-97`` does, initialised
    from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    stacks = {"graphsage": GraphSage, "gcn": GCN, "gin": GIN}
    if model == "gat":
        from gnn_tpu_torch.models.gat import GATEncoder
        stacks["gat"] = GATEncoder
    if model not in stacks:
        raise ValueError(f"unknown model {model!r}")
    encoder = stacks[model](n_feats, nhid, orders, dropout, gen)
    return GNN(encoder, num_classes, dropout, gen)
