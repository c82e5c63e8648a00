"""Graph attention on sampled minibatches: the counterpart of
`gnn_tpu.models.gat`.

A dot-product-attention GAT: per head, ``score(r, c) = (q_r · k_c) /
sqrt(d)`` restricted to the sampled edges, a row-wise softmax, and the
attention-weighted sum of ``v``; then ``elu(agg + self(x[sampled]))``.

Three device strategies:

* ``HotDenseAdj`` input (resident mode) — :func:`hot_attention_aggregate`:
  dense scores, softmax terms and aggregation over the resident block's
  batch-present slots (``torch.matmul``, as XLA computed them outside
  any Pallas kernel), plus the cold residual through the edge-stream
  attention kernels K3/K4 (`gnn_tpu_torch.ops.esattn`) when the batch
  ships stream tiles, or the per-edge route on a cold COO, or nothing
  when the layer has no cold edge. One row-wise softmax spans both parts.
* ``impl="tile"`` — :func:`tile_attention_aggregate`: every ``(bm, bk)``
  tile of the layer with a 0/1 edge mask, scores through the stream
  SDDMM (K5), a row-wise softmax over each row tile's tiles, aggregation
  through the stream SpMM (K2); the backward runs K5 and K2 in both
  orientations (:class:`_TileScores`, :class:`_TileAggregate`).
* ``impl="edge"`` — :func:`edge_attention_aggregate`: per-edge gathers
  and segment ops, O(nnz) memory.

``"auto"`` picks the tile route while the dense tile mask holds at most
``_TILE_MASK_LIMIT`` floats. Both routes take a value-carrying
:class:`~gnn_tpu_torch.ops.sparse.COOAdj`, the pattern-only
:class:`~gnn_tpu_torch.ops.sparse.PatternAdj` or a
:class:`~gnn_tpu_torch.ops.sparse.BlockedAdj`. The part-sharded resident
graph is not ported yet and raises ``NotImplementedError`` naming its
ROADMAP item.
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
from gnn_tpu_torch.ops.sddmm import stream_sddmm
from gnn_tpu_torch.ops.sparse import BlockedAdj, PatternAdj
from gnn_tpu_torch.ops.spmm import StreamBlocks, stream_spmm

# Per-edge chunk width of the per-edge routes: bounds the [chunk, n_out]
# gather temporaries (the JAX package's lax.scan chunk)
_EDGE_CHUNK = 131_072

# Above this many dense-mask floats per layer, "auto" picks the per-edge
# route over the tile route
_TILE_MASK_LIMIT = 64 * 1024 * 1024

_NEG_INF = float("-inf")
_SHARDED = ("part-sharded resident attention is not ported yet (ROADMAP "
            "queue 3: multi-device over torch.distributed)")


def _scale(d: int) -> float:
    """``1 / sqrt(d)`` in float32, as the JAX package computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _edges_of(adj):
    """``(rows, cols, live)`` of a sampled layer: a value-carrying COO
    (live = nonzero value), the pattern-only transport (rows re-expanded
    from the per-row counts), or the blocked layout (every nonzero tile
    entry, all live)."""
    if isinstance(adj, PatternAdj):
        return adj.expand()
    if isinstance(adj, BlockedAdj):
        rt, b, lr, lc = torch.nonzero(adj.block_vals, as_tuple=True)
        rows = rt * adj.bm + lr
        cols = adj.block_cols[rt, b].long() * adj.bk + lc
        return rows, cols, torch.ones_like(rows, dtype=torch.bool)
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
    """Multi-head edge-softmax attention over a sampled layer, O(nnz)
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


def _coo_to_tilewise(adj, bm: int = 128, bk: int = 128):
    """Every ``(bm, bk)`` tile of the layer, rt-major (``blk_rc`` int32
    [n_rt * n_ct]), with its 0/1 edge mask ``[n_rt * n_ct, bm, bk]``
    (float32), and ``t_order``, the same tiles in column-tile order. The
    JAX package builds all tiles too: which ones are occupied is data it
    cannot shape a traced array by."""
    n_rt, n_ct = adj.nrows // bm, adj.ncols // bk
    rows, cols, live = _edges_of(adj)
    dev = rows.device
    rt = torch.arange(n_rt, dtype=torch.int32, device=dev)
    ct = torch.arange(n_ct, dtype=torch.int32, device=dev)
    blk_rc = ((rt[:, None] << 16) | ct[None, :]).reshape(-1)
    t_order = (rt[None, :] * n_ct + ct[:, None]).reshape(-1)
    flat = ((((rows // bm) * n_ct + cols // bk) * bm + rows % bm) * bk
            + cols % bk)
    mask = torch.zeros(n_rt * n_ct * bm * bk, device=dev)
    mask.scatter_reduce_(0, flat, live.float(), "amax")
    return blk_rc, t_order, mask.reshape(n_rt * n_ct, bm, bk)


def masked_tile_softmax(blk_rc, scores, mask, n_rt: int):
    """Row-wise softmax over the edge scores of a tile stream
    (``scores``/``mask`` [NB, bm, bk]); each row's max and sum reduce over
    the tiles of its row tile. Rows with no live entry get all zeros
    (their max reads as 0, their sum clamps to 1e-20). The max is a
    softmax shift whose gradient cancels, so it stays out of the graph."""
    rt = (blk_rc >> 16).long()
    live = mask > 0
    neg = torch.where(live, scores,
                      torch.full((), _NEG_INF, device=scores.device))
    bm = scores.shape[1]
    row_max = torch.full((n_rt, bm), _NEG_INF, device=scores.device)
    row_max = row_max.scatter_reduce(
        0, rt[:, None].expand(-1, bm), neg.detach().amax(dim=2), "amax")
    row_max = torch.where(torch.isfinite(row_max), row_max,
                          torch.zeros((), device=scores.device))
    # the masked entries are -inf before the exp: exp gives 0 and its
    # gradient 0 * 0, never 0 * inf
    shifted = torch.exp(neg - row_max.index_select(0, rt)[:, :, None])
    shifted = torch.where(live, shifted,
                          torch.zeros((), device=scores.device))
    row_sum = scores.new_zeros((n_rt, bm)).index_add(0, rt,
                                                     shifted.sum(dim=2))
    denom = row_sum.index_select(0, rt)[:, :, None].clamp_min(1e-20)
    return shifted / denom


class _TileScores(torch.autograd.Function):
    """``S = K5(q, k)`` on every tile of the stream; backward
    ``dq = K2(dS, k)`` and ``dk = K2^T(dS, q)``."""

    @staticmethod
    def forward(ctx, blk_rc, t_order, q, k, bm: int, bk: int):
        ctx.save_for_backward(blk_rc, t_order, q, k)
        ctx.bm, ctx.bk = bm, bk
        return stream_sddmm(blk_rc, q, k, bm, bk)

    @staticmethod
    def backward(ctx, ds):
        blk_rc, t_order, q, k = ctx.saved_tensors
        ds_stream = StreamBlocks(blk_rc=blk_rc, vals=ds.contiguous(),
                                 nrows=q.shape[0], ncols=k.shape[0],
                                 bm=ctx.bm, bk=ctx.bk, t_order=t_order)
        dq = dk = None
        if ctx.needs_input_grad[2]:
            dq = stream_spmm(ds_stream, k)
        if ctx.needs_input_grad[3]:
            dk = stream_spmm(ds_stream, q, transpose=True)
        return None, None, dq, dk, None, None


class _TileAggregate(torch.autograd.Function):
    """``y = K2(att, v)``; backward ``d att = K5(g, v)`` and
    ``dv = K2^T(att, g)``."""

    @staticmethod
    def forward(ctx, blk_rc, t_order, att, v, nrows: int, bm: int,
                bk: int):
        ctx.save_for_backward(blk_rc, t_order, att, v)
        ctx.nrows, ctx.bm, ctx.bk = nrows, bm, bk
        return stream_spmm(StreamBlocks(blk_rc=blk_rc, vals=att,
                                        nrows=nrows, ncols=v.shape[0],
                                        bm=bm, bk=bk, t_order=t_order), v)

    @staticmethod
    def backward(ctx, g):
        blk_rc, t_order, att, v = ctx.saved_tensors
        g = g.contiguous()
        d_att = dv = None
        if ctx.needs_input_grad[2]:
            d_att = stream_sddmm(blk_rc, g, v, ctx.bm, ctx.bk)
        if ctx.needs_input_grad[3]:
            dv = stream_spmm(StreamBlocks(blk_rc=blk_rc, vals=att,
                                          nrows=ctx.nrows, ncols=v.shape[0],
                                          bm=ctx.bm, bk=ctx.bk,
                                          t_order=t_order), g,
                             transpose=True)
        return None, None, d_att, dv, None, None, None


def tile_attention_aggregate(adj, q_pad, k, v, n_heads: int, bm: int = 128,
                             bk: int = 128):
    """Multi-head attention over every tile of a layer: per head, scores
    through K5 (divided by ``sqrt(d)``), the masked tile softmax, and the
    aggregation through K2; heads run one after another."""
    H = n_heads
    d = k.shape[1] // H
    n_rt = adj.nrows // bm
    blk_rc, t_order, mask = _coo_to_tilewise(adj, bm, bk)
    sqrt_d = float(np.sqrt(np.float32(d)))
    heads = []
    for h in range(H):
        cols = slice(h * d, (h + 1) * d)
        scores = _TileScores.apply(blk_rc, t_order,
                                   q_pad[:, cols].contiguous(),
                                   k[:, cols].contiguous(), bm, bk) / sqrt_d
        att = masked_tile_softmax(blk_rc, scores, mask, n_rt)
        heads.append(_TileAggregate.apply(blk_rc, t_order, att,
                                          v[:, cols].contiguous(),
                                          adj.nrows, bm, bk))
    return heads[0] if H == 1 else torch.cat(heads, dim=1)


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
            if impl == "edge":
                agg = edge_attention_aggregate(adj, q_pad, k, v,
                                               self.n_heads)
            else:
                agg = tile_attention_aggregate(adj, q_pad, k, v,
                                               self.n_heads, self.bm,
                                               self.bk)
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
