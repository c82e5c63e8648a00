"""Graph attention on sampled minibatches: the counterpart of
`gnn_tpu.models.gat`.

A dot-product-attention GAT: per head, ``score(r, c) = (q_r · k_c) /
sqrt(d)`` restricted to the sampled edges, a row-wise softmax, and the
attention-weighted sum of ``v``; then ``elu(agg + self(x[sampled]))``.

Three device strategies:

* ``HotDenseAdj`` input (resident mode) — :func:`hot_attention` with a
  score source (:class:`DotScores` for ``gat``, :class:`AdditiveScores`
  for ``gatv1``). The source decides its hot part over the resident
  block's batch-present slots and hands it over as one object with a row
  max and softmax terms: on one part, either source's live entries alone
  through the hot attention kernels (`gnn_tpu_torch.ops.hotattn`: no
  ``[H, rh, ch]`` tensor); on a part's shard of the block, the dot
  product's dense scores, terms and aggregation (:class:`DenseGrid`:
  ``torch.matmul``, as XLA computed them outside any Pallas kernel). The
  cold residual runs through the edge-stream attention
  kernels K3/K4 (`gnn_tpu_torch.ops.esattn`, keyed by the source's
  operands) when the batch ships stream tiles, or the per-edge route on a
  cold COO, or nothing when the layer has no cold edge. One row-wise
  softmax spans both parts. :class:`AttentionCounts` counts attention's
  work for the trainer, by the same sources.
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
:class:`~gnn_tpu_torch.ops.sparse.BlockedAdj`.

On the part-sharded resident graph (``adj.part_axis`` set,
``--resident_parts P``; the dot-product source, its dense grid) each part
holds a slot-column shard of the block and masks its hot scores to the
columns it owns. The softmax terms then combine over the part group, as
the JAX package's ``_psum_terms`` and ``pmax`` do:

* the row max is a MAX over the part group of a score pass run without
  gradient (``part_max_``): it is only a shift, so no gradient flows
  through it;
* the hot terms (``den``, ``num``) go through :class:`_PartSumTerms`, an
  ``autograd.Function`` whose forward sums each part's partial terms over
  the part group and whose backward runs the local VJP and then sums the
  input cotangents over the part group, so every part holds the whole
  gradient. An in-place ``all_reduce`` alone would be invisible to
  autograd (each part would keep the gradient of its own columns only);
  ``torch.distributed.nn``'s differentiable all-reduce would sum the
  output cotangent, already equal on every part, and multiply the
  gradient by P;
* the cold residual: with stream tiles (K3/K4) it is replicated across
  the parts and summed by nobody; a cold COO from sharded full expansion
  (``adj.cold_partial``) holds only this part's rows, so its row max and
  terms combine like the hot ones.
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gnn_tpu_torch.models.gnn import _TRUNC_STD, Dense, _dropout
from gnn_tpu_torch.ops import esattn, hotattn
from gnn_tpu_torch.ops.hotdense import HotDenseAdj, _take_rows_fill
from gnn_tpu_torch.ops.sddmm import stream_sddmm
from gnn_tpu_torch.ops.sparse import BlockedAdj, PatternAdj
from gnn_tpu_torch.ops.spmm import StreamBlocks, stream_spmm
from gnn_tpu_torch.parallel.dist import part_max_, part_sum_
from gnn_tpu_torch.utils.timing import count, span

# Per-edge chunk width of the per-edge routes: bounds the [chunk, n_out]
# gather temporaries (the JAX package's lax.scan chunk)
_EDGE_CHUNK = 131_072

# Above this many dense-mask floats per layer, "auto" picks the per-edge
# route over the tile route
_TILE_MASK_LIMIT = 64 * 1024 * 1024

_NEG_INF = float("-inf")


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


class _PartSumTerms(torch.autograd.Function):
    """``fn(*args)`` summed over the part group; backward, the local VJP
    of ``fn`` with its input cotangents summed over the part group (the
    JAX package's ``_psum_terms``). Every part calls it alike, so the
    backward's one collective meets the other parts'."""

    @staticmethod
    def forward(ctx, part, fn, *args):
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(a.requires_grad)
                      for a in args]
            outs = fn(*leaves)
        ctx.part, ctx.leaves, ctx.outs = part, leaves, outs
        summed = [o.detach().clone() for o in outs]
        part_sum_(summed, part)
        return tuple(summed)

    @staticmethod
    def backward(ctx, *gouts):
        want = [i for i, a in enumerate(ctx.leaves) if a.requires_grad]
        got = torch.autograd.grad(ctx.outs, [ctx.leaves[i] for i in want],
                                  gouts, allow_unused=True)
        grads = [torch.zeros_like(ctx.leaves[i]) if g is None
                 else g.contiguous() for i, g in zip(want, got)]
        part_sum_(grads, ctx.part)
        out = [None] * len(ctx.leaves)
        for i, g in zip(want, grads):
            out[i] = g
        return (None, None, *out)


class DenseGrid:
    """The dot product's hot part on a part's shard of the block
    (``--resident_parts``): per head the dense ``[rh, ch]`` scores of a
    layer's batch-present slots, masked to the block's edges between true
    present slots in this part's slot columns; the row max and the terms
    combine over the part group (module docstring). A layer of one part
    takes its live entries instead (`gnn_tpu_torch.ops.hotattn.DotLiveGrid`);
    the part-sharded live route is queued (ROADMAP.md: gat-parts-live)."""

    def __init__(self, adj: HotDenseAdj, r_loc, c_loc, score, v):
        dev = v.device
        sentinel = 1 << 30
        rh = adj.present_row_slots.shape[0]
        ch = adj.present_col_slots.shape[0]
        # the present arrays pad by repeating slot 0: mask the pad entries
        # by the true present counts, or columns would aggregate twice
        n_hot_r = (adj.row_cmp_idx != sentinel).sum()
        n_hot_c = (adj.col_cmp_idx != sentinel).sum()
        row_ok = torch.arange(rh, device=dev) < n_hot_r
        col_ok = torch.arange(ch, device=dev) < n_hot_c
        d_rows = adj.dense.index_select(0, adj.present_row_slots.long())
        self.part = adj.part_axis
        # this part's slot columns only
        ksh = adj.dense.shape[1]
        pcs_loc = adj.present_col_slots.long() - self.part.rank * ksh
        col_ok = col_ok & (pcs_loc >= 0) & (pcs_loc < ksh)
        d_sub = d_rows.index_select(1, pcs_loc.clamp(0, ksh - 1))
        self.mask = (d_sub != 0) & row_ok[:, None] & col_ok[None, :]

        def split(a):   # [n, n_out] -> [H, n, d]
            return a.reshape(a.shape[0], score.H, -1).transpose(0, 1)
        self.qh = split(_take_rows_fill(score.q_pad, r_loc))
        self.kh = split(_take_rows_fill(score.k, c_loc))
        self.vh = split(_take_rows_fill(v, c_loc))
        self.scale = score.scale

    def _scores(self, qh, kh):
        """``[H, rh, ch]`` scores, -inf off the mask."""
        return torch.where(self.mask[None],
                           torch.matmul(qh, kh.transpose(1, 2)) * self.scale,
                           torch.full((), _NEG_INF, device=qh.device))

    def rowmax(self, count_live: bool) -> torch.Tensor:
        """``m_hot [H, rh]`` (-inf: no edge) over the part group, no
        gradient; the host counts the grid (:class:`AttentionCounts`), not
        ``count_live``."""
        with torch.no_grad():
            m_hot = self._scores(self.qh, self.kh).amax(2).contiguous()
        part_max_(m_hot, self.part)
        return m_hot

    def terms(self, rm_cmp: torch.Tensor):
        """``(den_hot [H, rh], num_hot [H, rh, d])`` for the combined row
        max of the present rows ``rm_cmp [rh, H]``, summed over the part
        group."""
        def hot_terms(qh, kh, vh):
            # the scores are -inf wherever masked BEFORE the exp: a masked
            # entry's raw s - rm could overflow, and its exp gradient would
            # be 0 * inf
            e = torch.exp(self._scores(qh, kh) - rm_cmp.t()[:, :, None])
            return e.sum(dim=2), torch.matmul(e, vh)

        return _PartSumTerms.apply(self.part, hot_terms, self.qh, self.kh,
                                   self.vh)


class DotScores:
    """The dot-product score source of :func:`hot_attention`: per head
    ``s = q_r·k_c / sqrt(d)`` (``gat``). Its hot part runs on its live
    entries on one part (`gnn_tpu_torch.ops.hotattn.DotLiveGrid`, counted
    on the card) and as the dense grid on a part's shard of the block
    (:class:`DenseGrid`, whose entries the host counts); its cold residual
    runs K3/K4 with the scale folded into ``q``."""

    self_pos = None
    slope = None

    @staticmethod
    def dense_grid(sharded: bool) -> bool:
        """Whether the hot part is the dense grid (attn.dense_entries
        counts it): on a part's shard of the block only."""
        return sharded

    def __init__(self, q_pad, k, n_heads: int):
        self.q_pad, self.k, self.H = q_pad, k, n_heads
        self.scale = _scale(k.shape[1] // n_heads)

    def hot_part(self, adj, r_loc, c_loc, v):
        """The live entries alone on one part (a bit mask of the present
        grid and the gathered operands; no ``[H, rh, ch]`` tensor); the
        dense grid on a part's shard."""
        if self.dense_grid(adj.part_axis is not None):
            return DenseGrid(adj, r_loc, c_loc, self, v)
        return hotattn.dot_live_grid(adj, r_loc, c_loc, self.q_pad, self.k,
                                     v, self.H, self.scale)

    def edge_operands(self):
        return self.q_pad, self.k

    def edge(self, rows, cols, live, q, k):
        return _edge_scores(q, k, rows, cols, live, self.H, self.scale)

    def cold_operands(self):
        """K3/K4's operands: the scale folds into ``q`` once."""
        return self.q_pad * self.scale, self.k


class AdditiveScores:
    """The additive score source of :func:`hot_attention` (``gatv1``,
    arXiv:1710.10903): per head ``s = lrelu(el[r, h] + er[c, h])`` with
    ``el`` of the rows ``[nrows, H]`` and ``er`` of the columns ``[ncols,
    H]``. Every row also attends to itself, column ``self_pos[r]``: that
    edge is a term of its own (:meth:`self_scores`), and the hot mask,
    the cold kernels and the cold COO leave it out where the layer holds
    it, so it counts once. Its hot part runs on its live entries alone
    (`gnn_tpu_torch.ops.hotattn`, counted on the card), on one part."""

    @staticmethod
    def dense_grid(sharded: bool) -> bool:
        """Never: the hot part is the live entries, which the card
        counts."""
        return False

    def __init__(self, el_pad, er, self_pos, slope: float = 0.2):
        self.el, self.er, self.self_pos = el_pad, er, self_pos
        self.H = er.shape[1]
        self.slope = slope

    def hot_part(self, adj, r_loc, c_loc, v) -> hotattn.LiveGrid:
        """The hot part on its live entries alone (a bit mask of the
        present grid and the gathered operands; no ``[H, rh, ch]``
        tensor)."""
        return hotattn.live_grid(adj, r_loc, c_loc, self.el, self.er, v,
                                 self.self_pos, self.slope)

    def edge_operands(self):
        return self.el, self.er

    def edge(self, rows, cols, live, el, er):
        s = F.leaky_relu(el.index_select(0, rows) + er.index_select(0, cols),
                         self.slope)
        return torch.where(live[:, None], s,
                           torch.full((), _NEG_INF, device=s.device))

    def cold_operands(self):
        return self.el, self.er, self.self_pos

    def self_scores(self):
        """``[nrows, H]`` scores of each row's self edge."""
        return F.leaky_relu(
            self.el + self.er.index_select(0, self.self_pos.long()),
            self.slope)


def hot_attention(adj: HotDenseAdj, score, v):
    """Hot-block attention on a resident layer: the batch's hot-hot edges
    over the batch-present compacted slots (the score source's hot part:
    `gnn_tpu_torch.ops.hotattn.DotLiveGrid` or ``LiveGrid`` on one part,
    :class:`DenseGrid` on a part's shard), the cold
    residual through K3/K4 (stream tiles, ``adj.es_rc`` set), the
    per-edge route (cold COO) or nothing (no cold edge), and, for a
    source with ``self_pos``, each row's self edge; one row-wise softmax
    spans them all. ``score`` is the score source (:class:`DotScores`,
    :class:`AdditiveScores`). On a part's shard of the block
    (``adj.part_axis``) the terms combine over the part group (module
    docstring)."""
    part = adj.part_axis
    H = score.H
    n_out = v.shape[1]
    d = n_out // H
    dev = v.device
    use_es = adj.es_rc is not None
    cold_empty = (not use_es) and adj.rows.shape[0] == 0
    if use_es and adj.cold_partial:
        raise ValueError("stream tiles are replicated across parts (lite "
                         "mode); a partial cold residual comes as a COO")

    # --- hot part: over the batch-present compacted [rh, ch] slots ---
    rh = adj.present_row_slots.shape[0]
    r_loc = adj.rowpos.index_select(0, adj.present_row_slots.long())
    c_loc = adj.colpos.index_select(0, adj.present_col_slots.long())
    hot = score.hot_part(adj, r_loc, c_loc, v)
    # the row max without gradient (a softmax shift); a training forward
    # counts the live entries it walks
    m_hot = hot.rowmax(count_live=torch.is_grad_enabled())

    # --- cold residual, pass 1: per-row score max ---
    if use_es:
        cold_ops = score.cold_operands()
        cold_kw = dict(n_heads=H, bm=adj.es_bm, bk=adj.es_bk,
                       slope=score.slope)
        m_cold = esattn.cold_rowmax(adj.es_coords, adj.es_rc, adj.es_off,
                                    tuple(o.detach() for o in cold_ops),
                                    **cold_kw)
        # the kernel writes float32 min for rows without a cold edge;
        # restore the -inf the combine below expects
        m_cold = torch.where(m_cold > esattn.NEG_SENTINEL / 2, m_cold,
                             torch.full((), _NEG_INF, device=dev))
    elif cold_empty:
        m_cold = torch.full((adj.nrows, H), _NEG_INF, device=dev)
    else:
        rows_c, cols_c = adj.rows.long(), adj.cols.long()
        live = adj.vals.float() != 0   # pads ship exactly 0
        if score.self_pos is not None:
            live = live & (score.self_pos.long().index_select(0, rows_c)
                           != cols_c)
        # a partial COO's terms recompute their scores inside the Function
        # below, so its score pass here serves the max alone
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not adj.cold_partial):
            s_cold = score.edge(rows_c, cols_c, live,
                                *score.edge_operands())
        m_cold = _segment_max(s_cold.detach(), rows_c, adj.nrows)
        if adj.cold_partial:
            part_max_(m_cold, part)

    # --- one softmax across both parts (and the self edges) ---
    m_hot_rows = _take_rows_fill(m_hot.t(), adj.row_cmp_idx,
                                 fill=_NEG_INF)               # [nrows, H]
    row_max = torch.maximum(m_cold, m_hot_rows)
    if score.self_pos is not None:
        s_self = score.self_scores()                          # [nrows, H]
        row_max = torch.maximum(row_max, s_self.detach())
    row_max = torch.where(torch.isfinite(row_max), row_max,
                          torch.zeros((), device=dev)).detach()
    rm_cmp = _take_rows_fill(row_max, r_loc)                  # [rh, H]
    den_hot, num_hot = hot.terms(rm_cmp)

    # --- cold pass 2: softmax denominators + aggregation ---
    if use_es:
        den_cold, num_cold = esattn.cold_terms(
            adj.es_coords, adj.es_rc, adj.es_off, adj.es_ord, cold_ops, v,
            row_max, **cold_kw)
    elif cold_empty:
        den_cold = torch.zeros((adj.nrows, H), device=dev)
        num_cold = torch.zeros((adj.nrows, n_out), device=dev)
    else:
        def cold_terms(s_c, v_):
            att = (torch.exp(s_c - _take_rows_fill(row_max, rows_c))
                   * live[:, None])                           # [nnz, H]
            return (att.new_zeros((adj.nrows, H)).index_add(0, rows_c, att),
                    _edge_aggregate(att, rows_c, cols_c, v_, adj.nrows, H))

        if adj.cold_partial:
            den_cold, num_cold = _PartSumTerms.apply(
                part, lambda *a: cold_terms(score.edge(
                    rows_c, cols_c, live, *a[:-1]), a[-1]),
                *score.edge_operands(), v)
        else:
            den_cold, num_cold = cold_terms(s_cold, v)
    num_cold = num_cold.to(v.dtype)

    den = _take_rows_fill(den_hot.t(), adj.row_cmp_idx) + den_cold
    num = num_cold + _take_rows_fill(
        num_hot.transpose(0, 1).reshape(rh, n_out),
        adj.row_cmp_idx).to(v.dtype)                          # [nrows, n_out]
    if score.self_pos is not None:
        e_self = torch.exp(s_self - row_max)                  # [nrows, H]
        v_self = v.index_select(0, score.self_pos.long())
        den = den + e_self
        num = num + (e_self[:, :, None] * v_self.reshape(
            adj.nrows, H, d)).reshape(adj.nrows, n_out)
    # den == 0 exactly iff the row has no edge (pad rows): substitute 1,
    # not a tiny epsilon, whose squared reciprocal in the division's
    # gradient overflows to inf and makes 0 * inf = NaN cotangents
    den_e = torch.where(den > 0, den, torch.ones((), device=dev))
    return (num.reshape(adj.nrows, H, d) / den_e[:, :, None]).reshape(
        adj.nrows, n_out)


class GATConv(nn.Module):
    """Multi-head dot-product graph attention over a sampled adjacency
    (flax ``GATConv``: Dense ``q``, ``k``, ``v`` and ``self``)."""

    scores = DotScores     # the score source of its resident hot part

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
            agg = hot_attention(adj, self.scores(q_pad, k, self.n_heads), v)
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


# the published GAT's inductive heads (arXiv:1710.10903, section 3.3):
# hidden layers of 4 concatenated heads, an output layer of 6 averaged
GATV1_HIDDEN_HEADS = 4
GATV1_OUTPUT_HEADS = 6
GATV1_SLOPE = 0.2


class GATv1Conv(nn.Module):
    """One layer of the published GAT (arXiv:1710.10903): ``z = W x`` (no
    bias), per head ``el = a_dst·z_r`` on the output rows and ``er =
    a_src·z_c`` on the columns, the softmax of ``lrelu(el + er)`` over
    each row's sampled edges and the row itself, ``sum alpha z_c`` plus a
    per-head bias; then the residual projection where there is one
    (``residual``, with bias, added before the activation) and either ELU
    over the concatenated heads or, at the output (``mean``), the mean of
    the heads. Edge values (LADIES' debias weights) do not enter: only
    the pattern counts. Resident layers (``HotDenseAdj``) on one part
    only."""

    scores = AdditiveScores

    def __init__(self, n_in: int, d: int, n_heads: int, mean: bool = False,
                 residual: bool = False, generator=None):
        super().__init__()
        self.d, self.n_heads, self.mean = d, n_heads, mean
        n_out = d * n_heads
        self.W = nn.Linear(n_in, n_out, bias=False)
        std = (1.0 / n_in) ** 0.5 / _TRUNC_STD
        a_std = (1.0 / d) ** 0.5 / _TRUNC_STD
        self.a_src = nn.Parameter(torch.empty(n_heads, d))
        self.a_dst = nn.Parameter(torch.empty(n_heads, d))
        with torch.no_grad():
            nn.init.trunc_normal_(self.W.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
            for a in (self.a_src, self.a_dst):
                nn.init.trunc_normal_(a, std=a_std, a=-2 * a_std,
                                      b=2 * a_std, generator=generator)
        self.bias = nn.Parameter(torch.zeros(n_out))
        self.res = Dense(n_in, n_out, generator) if residual else None

    def forward(self, x, adj, sampled_nodes):
        if not isinstance(adj, HotDenseAdj):
            raise NotImplementedError(
                "gatv1 runs on the resident format only (ROADMAP.md: "
                "gatv1-formats)")
        if adj.part_axis is not None:
            raise NotImplementedError(
                "gatv1 runs on the whole resident block, not a part's shard "
                "(ROADMAP.md: gatv1-parts)")
        H, d = self.n_heads, self.d
        # a span in eager steps only: a capture records it once and a
        # replay never
        with (contextlib.nullcontext()
              if x.is_cuda and torch.cuda.is_current_stream_capturing()
              else span("attn.additive")):
            z = self.W(x)                                     # [ncols, H d]
            self_pos = _self_pos(sampled_nodes, adj.nrows)
            z_rows = z.index_select(0, self_pos.long())
            el = (z_rows.reshape(-1, H, d) * self.a_dst).sum(-1)
            er = (z.reshape(-1, H, d) * self.a_src).sum(-1)
            agg = hot_attention(adj, self.scores(el, er, self_pos,
                                                 GATV1_SLOPE), z)
        out = agg + self.bias
        if self.res is not None:
            x_rows = x.index_select(0, self_pos.long())
            out = out + self.res(x_rows)
        if self.mean:
            return out.reshape(-1, H, d).mean(dim=1)
        return F.elu(out)


def _self_pos(sampled_nodes, nrows: int):
    """Each output row's column (``sampled_nodes``, int32 ``[nrows]``):
    LADIES puts every output row among its layer's columns. Rows past
    the sampled array read column 0."""
    s = sampled_nodes[:nrows].to(torch.int32)
    if s.shape[0] < nrows:
        s = torch.cat([s, s.new_zeros(nrows - s.shape[0])])
    return s


class GATv1(nn.Module):
    """The published GAT at its inductive widths (arXiv:1710.10903, PPI):
    ``len(orders)`` attention layers, the hidden ones of
    ``GATV1_HIDDEN_HEADS`` heads of ``nhid / GATV1_HIDDEN_HEADS``
    features concatenated (ELU), a residual projection on the second
    hidden layer, and an output layer of ``GATV1_OUTPUT_HEADS`` heads of
    ``num_classes`` features averaged into the logits; dropout after
    every hidden layer. No L2 norm and no classifier follow. Every
    order must be 1. The head counts are the model's (no flag sets
    them); the tests pass smaller ones."""

    def __init__(self, n_in: int, nhid: int, orders: Sequence[int],
                 num_classes: int, dropout: float = 0.1, generator=None,
                 hidden_heads: int = GATV1_HIDDEN_HEADS,
                 output_heads: int = GATV1_OUTPUT_HEADS):
        super().__init__()
        orders = tuple(orders)
        if any(o != 1 for o in orders):
            raise NotImplementedError(
                f"gatv1 takes orders of 1 (got {orders}): an order-0 layer "
                "has no counterpart in the published model")
        if nhid % hidden_heads:
            raise ValueError(f"nhid {nhid} is not a multiple of "
                             f"{hidden_heads} heads")
        self.nhid, self.orders = nhid, orders
        self.dropout = dropout
        d = nhid // hidden_heads
        layers, f_in = [], n_in
        for i in range(len(orders)):
            last = i == len(orders) - 1
            layers.append(GATv1Conv(
                f_in, num_classes if last else d,
                output_heads if last else hidden_heads, mean=last,
                residual=i == 1 and not last, generator=generator))
            f_in = nhid
        self.layers = nn.ModuleList(layers)

    def forward(self, feat, adjs, sampled_nodes, generator=None):
        x = feat
        for i, layer in enumerate(self.layers):
            x = layer(x, adjs[i], sampled_nodes[i])
            if i < len(self.layers) - 1:
                x = _dropout(x, self.dropout, self.training, generator)
        return x


def _attention_layers(net) -> list:
    """The layers of ``net`` in order (None for a layer without
    attention); empty for a model without attention."""
    if isinstance(net, GATv1):
        return list(net.layers)
    enc = getattr(net, "encoder", None)
    if isinstance(enc, GATEncoder):
        return [layer if isinstance(layer, GATConv) else None
                for layer in enc.layers]
    return []


def attention_heads(net) -> list:
    """Per layer of ``net``, the heads of its attention (0 for a layer
    without one); empty for a model without attention."""
    return [0 if layer is None else layer.n_heads
            for layer in _attention_layers(net)]


class AttentionCounts:
    """Attention's counters of one net, in the current epoch. Where a
    training batch is staged (:meth:`staged`; a CUDA-graph replay runs no
    forward on the host): ``attn.dense_entries``, ``H * rh * ch`` of each
    resident layer whose score source's hot part is the dense grid (its
    padded present rows and columns; the dot product's on a part's shard
    of the block, ``sharded``), and ``attn.cold_slots``, the packed cold
    edge slots (stream tiles' coords, else the cold COO's). Where an
    epoch already waits for the card (:meth:`epoch_end`):
    ``attn.hot_live_entries``, the live hot entries the card counted."""

    def __init__(self, layers: list, sharded: bool = False):
        self.layers = layers
        self.sharded = sharded

    @classmethod
    def of(cls, net, sharded: bool = False) -> "AttentionCounts | None":
        """The counters of ``net`` (``sharded``: its resident layers are a
        part's shard of the block); None for a model without
        attention."""
        layers = _attention_layers(net)
        return cls(layers, sharded) if layers else None

    def staged(self, mb) -> None:
        """Count a host training batch (`MiniBatch`)."""
        entries = slots = 0
        for a, layer in zip(mb.adjs, self.layers):
            rh = getattr(a, "rh_pad", 0)
            if layer is None or not rh:
                continue
            if layer.scores.dense_grid(self.sharded):
                entries += layer.n_heads * rh * a.ch_pad
            cold = a.es_coords if a.es_coords is not None else a.cols
            slots += 0 if cold is None else cold.size
        count("attn.dense_entries", entries)
        count("attn.cold_slots", slots)

    @staticmethod
    def epoch_end() -> None:
        """Record what the card counted since the last call: one read of
        the live-entry buffer, a wait on the card."""
        hotattn.record_live_entries()
