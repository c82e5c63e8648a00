"""Graph attention on sampled minibatches: the counterpart of
`gnn_tpu.models.gat`.

A dot-product-attention GAT: per head, ``score(r, c) = (q_r · k_c) /
sqrt(d)`` restricted to the sampled edges, a row-wise softmax, and the
attention-weighted sum of ``v``; then ``elu(agg + self(x[sampled]))``.

Two device strategies are ported:

* ``HotDenseAdj`` input (resident mode) — :func:`hot_attention_aggregate`:
  dense scores, softmax terms and aggregation over the resident block's
  batch-present slots (``torch.matmul``, as XLA computed them outside
  any Pallas kernel), plus the cold residual through the edge-stream
  attention kernels K3/K4 (`gnn_tpu_torch.ops.esattn`) when the batch
  ships stream tiles, or the per-edge route on a cold COO, or nothing
  when the layer has no cold edge. One row-wise softmax spans both parts.
* ``impl="edge"`` on a :class:`~gnn_tpu_torch.ops.sparse.COOAdj` —
  :func:`edge_attention_aggregate`: per-edge gathers and segment ops,
  O(nnz) memory.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: the tile route (``impl="tile"``, and ``"auto"`` where it resolves
to it: it needs K2), the pattern-only transport (``PatternAdj``) and the
part-sharded resident graph.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gnn_tpu_torch.models.gnn import Dense, _dropout
from gnn_tpu_torch.ops import esattn
from gnn_tpu_torch.ops.hotdense import HotDenseAdj, _take_rows_fill
from gnn_tpu_torch.ops.sparse import COOAdj

# Per-edge chunk width of the per-edge routes: bounds the [chunk, n_out]
# gather temporaries (the JAX package's lax.scan chunk)
_EDGE_CHUNK = 131_072

# Above this many dense-mask floats per layer, "auto" picks the per-edge
# route over the tile route
_TILE_MASK_LIMIT = 64 * 1024 * 1024

_NEG_INF = float("-inf")
_TILE_ROUTE = ("GAT's tile route (impl='tile') is not ported yet (ROADMAP "
               "queue 3: the GAT tile route with K2)")
_SHARDED = ("part-sharded resident attention is not ported yet (ROADMAP "
            "queue 4: multi-device over torch.distributed)")


def _scale(d: int) -> float:
    """``1 / sqrt(d)`` in float32, as the JAX package computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _edges_of(adj):
    """``(rows, cols, live)`` of a value-carrying COO layer (live =
    nonzero value)."""
    if not isinstance(adj, COOAdj):
        raise NotImplementedError(
            f"GAT on {type(adj).__name__} is not ported yet (PatternAdj: "
            f"ROADMAP queue 1: format leftovers and the subgraph sampler)")
    return adj.rows.long(), adj.cols.long(), adj.vals != 0


def _edge_scores(q, k, rows, cols, live, H, scale):
    """``s[e, h] = q[rows[e], h]·k[cols[e], h] * scale``, ``-inf`` where
    the edge is not live ([nnz, H]), in chunks of ``_EDGE_CHUNK``."""
    d = k.shape[1] // H
    parts = []
    for s in range(0, rows.shape[0], _EDGE_CHUNK):
        sl = slice(s, s + _EDGE_CHUNK)
        qe = q.index_select(0, rows[sl]).reshape(-1, H, d)
        ke = k.index_select(0, cols[sl]).reshape(-1, H, d)
        sc = (qe * ke).sum(-1) * scale
        parts.append(torch.where(live[sl, None], sc,
                                 torch.full((), _NEG_INF, device=sc.device)))
    if not parts:
        return q.new_zeros((0, H))
    return torch.cat(parts)


def _segment_max(vals, idx, n):
    """Per-segment max of ``vals`` [E, H] over ``idx``; ``-inf`` for
    empty segments (``jax.ops.segment_max``)."""
    out = torch.full((n, vals.shape[1]), _NEG_INF, dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce(0, idx[:, None].expand_as(vals), vals, "amax")


def _edge_aggregate(att, rows, cols, v, nrows, H):
    """``y[r, h] = sum_e att[e, h] * v[cols[e], h]`` over edges with
    ``rows[e] == r``, in chunks of ``_EDGE_CHUNK``."""
    n_out = v.shape[1]
    d = n_out // H
    y = v.new_zeros((nrows, n_out))
    for s in range(0, rows.shape[0], _EDGE_CHUNK):
        sl = slice(s, s + _EDGE_CHUNK)
        ve = v.index_select(0, cols[sl]).reshape(-1, H, d)
        y = y.index_add(0, rows[sl],
                        (ve * att[sl, :, None]).reshape(-1, n_out))
    return y


def edge_attention_aggregate(adj, q_pad, k, v, n_heads: int):
    """Multi-head edge-softmax attention over a padded COO layer, O(nnz)
    memory: per-edge scores, a segment softmax over each output row, and
    the per-edge aggregation."""
    H = n_heads
    rows, cols, live = _edges_of(adj)
    scale = _scale(k.shape[1] // H)
    scores = _edge_scores(q_pad, k, rows, cols, live, H, scale)
    # the softmax shift's gradient cancels: it stays out of the graph
    row_max = _segment_max(scores.detach(), rows, adj.nrows)
    row_max = torch.where(torch.isfinite(row_max), row_max,
                          torch.zeros((), device=row_max.device))
    att = torch.exp(scores - row_max.index_select(0, rows)) * live[:, None]
    denom = att.new_zeros((adj.nrows, H)).index_add(0, rows, att)
    att = att / denom.index_select(0, rows).clamp_min(1e-20)
    return _edge_aggregate(att, rows, cols, v, adj.nrows, H)


def hot_attention_aggregate(adj: HotDenseAdj, q_pad, k, v, n_heads: int):
    """Hot-block attention on a resident layer: the batch's hot-hot edges
    as dense ``[H, rh, ch]`` scores over the batch-present compacted
    slots, the cold residual through K3/K4 (stream tiles, ``adj.es_rc``
    set), the per-edge route (cold COO) or nothing (no cold edge); one
    row-wise softmax spans both parts."""
    if getattr(adj, "part_axis", None) is not None or getattr(
            adj, "cold_partial", False):
        raise NotImplementedError(_SHARDED)
    H = n_heads
    n_out = k.shape[1]
    d = n_out // H
    scale = _scale(d)
    dev = k.device
    use_es = adj.es_rc is not None
    cold_empty = (not use_es) and adj.rows.shape[0] == 0

    # --- hot part: compacted [rh, ch] dense scores ---
    sentinel = 1 << 30
    rh = adj.present_row_slots.shape[0]
    ch = adj.present_col_slots.shape[0]
    r_loc = adj.rowpos.index_select(0, adj.present_row_slots.long())
    c_loc = adj.colpos.index_select(0, adj.present_col_slots.long())
    # the present arrays pad by repeating slot 0: mask the pad entries by
    # the true present counts, or columns would aggregate twice
    n_hot_r = (adj.row_cmp_idx != sentinel).sum()
    n_hot_c = (adj.col_cmp_idx != sentinel).sum()
    row_ok = torch.arange(rh, device=dev) < n_hot_r
    col_ok = torch.arange(ch, device=dev) < n_hot_c
    d_sub = adj.dense.index_select(0, adj.present_row_slots.long()
                                   ).index_select(1, adj.present_col_slots
                                                  .long())
    mask_hot = (d_sub != 0) & row_ok[:, None] & col_ok[None, :]

    def split(a):   # [n, n_out] -> [H, n, d]
        return a.reshape(a.shape[0], H, d).transpose(0, 1)

    qh = split(_take_rows_fill(q_pad, r_loc))
    kh = split(_take_rows_fill(k, c_loc))
    vh = split(_take_rows_fill(v, c_loc))
    # ONE differentiable score matmul serves the row max (detached: the
    # max is a softmax shift whose gradient cancels) and the terms below
    s_hot = torch.matmul(qh, kh.transpose(1, 2)) * scale      # [H, rh, ch]
    s_hot = torch.where(mask_hot[None], s_hot,
                        torch.full((), _NEG_INF, device=dev))
    m_hot = s_hot.detach().amax(dim=2)                        # [H, rh]

    # --- cold residual, pass 1: per-row score max ---
    if use_es:
        qs = q_pad * scale            # the scale folds into q once
        m_cold = esattn.cold_attention_rowmax(
            adj.es_coords, adj.es_rc, adj.es_off, qs.detach(), k.detach(),
            n_heads=H, bm=adj.es_bm, bk=adj.es_bk)
        # the kernel writes float32 min for rows without a cold edge;
        # restore the -inf the combine below expects
        m_cold = torch.where(m_cold > esattn.NEG_SENTINEL / 2, m_cold,
                             torch.full((), _NEG_INF, device=dev))
    elif cold_empty:
        m_cold = torch.full((adj.nrows, H), _NEG_INF, device=dev)
    else:
        rows_c, cols_c = adj.rows.long(), adj.cols.long()
        live = adj.vals.float() != 0   # pads ship exactly 0
        s_cold = _edge_scores(q_pad, k, rows_c, cols_c, live, H, scale)
        m_cold = _segment_max(s_cold.detach(), rows_c, adj.nrows)

    # --- one softmax across both parts ---
    m_hot_rows = _take_rows_fill(m_hot.t(), adj.row_cmp_idx,
                                 fill=_NEG_INF)               # [nrows, H]
    row_max = torch.maximum(m_cold, m_hot_rows)
    row_max = torch.where(torch.isfinite(row_max), row_max,
                          torch.zeros((), device=dev)).detach()
    rm_cmp = _take_rows_fill(row_max, r_loc)                  # [rh, H]
    # s_hot is -inf wherever masked BEFORE the exp: a masked entry's raw
    # s - rm could overflow, and its exp gradient would be 0 * inf = NaN
    e_hot = torch.exp(s_hot - rm_cmp.t()[:, :, None])
    den_hot = e_hot.sum(dim=2)                                # [H, rh]
    num_hot = torch.matmul(e_hot, vh)                         # [H, rh, d]

    # --- cold pass 2: softmax denominators + aggregation ---
    if use_es:
        den_cold, num_cold = esattn.cold_attention_terms(
            adj.es_coords, adj.es_rc, adj.es_off, adj.es_ord, qs, k, v,
            row_max, n_heads=H, bm=adj.es_bm, bk=adj.es_bk)
    elif cold_empty:
        den_cold = torch.zeros((adj.nrows, H), device=dev)
        num_cold = torch.zeros((adj.nrows, n_out), device=dev)
    else:
        att = (torch.exp(s_cold - _take_rows_fill(row_max, rows_c))
               * live[:, None])                               # [nnz, H]
        den_cold = att.new_zeros((adj.nrows, H)).index_add(0, rows_c, att)
        num_cold = _edge_aggregate(att, rows_c, cols_c, v, adj.nrows, H)
    num_cold = num_cold.to(v.dtype)

    den = _take_rows_fill(den_hot.t(), adj.row_cmp_idx) + den_cold
    num = num_cold + _take_rows_fill(
        num_hot.transpose(0, 1).reshape(rh, n_out),
        adj.row_cmp_idx).to(v.dtype)                          # [nrows, n_out]
    # den == 0 exactly iff the row has no edge (pad rows): substitute 1,
    # not a tiny epsilon, whose squared reciprocal in the division's
    # gradient overflows to inf and makes 0 * inf = NaN cotangents
    den_e = torch.where(den > 0, den, torch.ones((), device=dev))
    return (num.reshape(adj.nrows, H, d) / den_e[:, :, None]).reshape(
        adj.nrows, n_out)


class GATConv(nn.Module):
    """Multi-head dot-product graph attention over a sampled adjacency
    (flax ``GATConv``: Dense ``q``, ``k``, ``v`` and ``self``)."""

    def __init__(self, n_in: int, n_out: int, n_heads: int = 1,
                 bm: int = 128, bk: int = 128, impl: str = "auto",
                 generator=None):
        super().__init__()
        assert n_out % n_heads == 0, (n_out, n_heads)
        self.n_out, self.n_heads = n_out, n_heads
        self.bm, self.bk, self.impl = bm, bk, impl
        self.q = Dense(n_in, n_out, generator)
        self.k = Dense(n_in, n_out, generator)
        self.v = Dense(n_in, n_out, generator)
        # flax names this submodule "self"; so does the state_dict
        self.self = Dense(n_in, n_out, generator)

    def forward(self, x, adj, sampled_nodes):
        sampled = sampled_nodes.long()
        q, k, v = self.q(x), self.k(x), self.v(x)
        # q rows live in the output index space
        q_rows = q.index_select(0, sampled)[: adj.nrows]
        q_pad = torch.cat([q_rows, q.new_zeros(
            (adj.nrows - q_rows.shape[0], self.n_out))])
        if isinstance(adj, HotDenseAdj):
            agg = hot_attention_aggregate(adj, q_pad, k, v, self.n_heads)
        else:
            impl = self.impl
            if impl == "auto":
                n_tiles = (adj.nrows // self.bm) * (adj.ncols // self.bk)
                impl = ("tile" if n_tiles * self.bm * self.bk
                        <= _TILE_MASK_LIMIT else "edge")
            if impl != "edge":
                raise NotImplementedError(_TILE_ROUTE)
            agg = edge_attention_aggregate(adj, q_pad, k, v, self.n_heads)
        return F.elu(agg + self.self(x.index_select(0, sampled)))


class _GATDense(Dense):
    """An order-0 GAT layer: ``elu(Dense(x))`` (flax names its params
    ``gcs_{i}/{kernel,bias}`` directly)."""

    def forward(self, x, adj=None, sampled_nodes=None):
        return F.elu(super().forward(x))


class GATEncoder(nn.Module):
    """Stack of GATConv layers (``Dense`` + ELU at order 0), dropout
    after every layer; drop-in beside GraphSage/GCN/GIN."""

    def __init__(self, n_in: int, nhid: int, orders: Sequence[int],
                 dropout: float = 0.1, generator=None, n_heads: int = 1,
                 impl: str = "auto"):
        super().__init__()
        self.nhid = nhid
        self.orders = tuple(orders)
        self.dropout = dropout
        widths = [n_in] + [nhid] * (len(self.orders) - 1)
        self.layers = nn.ModuleList(
            [GATConv(w, nhid, n_heads=n_heads, impl=impl,
                     generator=generator) if o > 0
             else _GATDense(w, nhid, generator)
             for w, o in zip(widths, self.orders)])

    @property
    def out_dim(self) -> int:
        return self.nhid

    def forward(self, x, adjs, sampled_nodes, generator=None):
        for i, layer in enumerate(self.layers):
            x = layer(x, adjs[i], sampled_nodes[i])
            x = _dropout(x, self.dropout, self.training, generator)
        return x
