"""Persistent hot-subgraph dense aggregation: the PyTorch counterpart of
`gnn_tpu.ops.hotdense`.

The dense adjacency among the K nodes most likely to be sampled,
``D = lap[H][:, H]`` (plus its transpose for the backward), stays
resident on the device. Each sampled layer splits into

    y = D-part + cold-part
    D-part: xh[s] = x[colpos[s]] * nfh[s]          (gather to slots)
            yh_c  = D[present_row_slots] @ xh      (row-compacted matmul)
            y[r] += yh_c[row_cmp_idx[r]]           (gather back)
    cold:   the residual edges, through the edge-stream CUDA kernel
            (`gnn_tpu_torch.ops.edgestream`) or a COO ``index_add_``

On the part-sharded resident graph (``--resident_parts P``,
`gnn_tpu_torch.parallel.shardedresident`) ``dense`` / ``dense_t`` are
this rank's slot-column shards ``[k, k/P]`` and the layer carries its
part group (``part_axis``, the JAX field's name): the D-part gathers and
contracts only the local slot range (``colpos``, ``nfh``, ``rowpos``
sliced to it) and one sum over the part group restores the ``[rh, F]``
product, in :func:`hot_block_forward` and in :func:`hot_block_transpose`
alike. ``_SpMM``'s backward runs
:func:`hot_transpose`, so the backward needs no Function of its own:
its cotangent is the same on every part (every part computed the same
forward), each part's transposed partial covers its own slot columns,
and the sum is the whole ``A^T @ g``. (An in-place sum outside the
forward and transposed products would be invisible to autograd and
leave each part a partial gradient; the autograd-aware all-reduce of
``torch.distributed.nn`` would sum the already-equal cotangents and
multiply the gradient by P.) With ``cold_partial`` (sharded full
expansion) each part's cold COO holds only the rows it owns, and the
cold product is summed over the part group too.

Two ways to feed it: the resident rebuild
(`gnn_tpu_torch.ops.residentgraph`) derives each layer on the device,
and ``adj_format="hot"`` packs each layer on the host
(:func:`pack_hotdense`: the cold COO, its col-sorted transpose copy and
the k-sized slot plumbing ship every step); :func:`bind_dense` then
attaches the resident blocks to the shipped layers.

The JAX package marks absent slots and rows with out-of-range sentinels
(``colpos = ncols``, ``rowpos = nrows``, ``*_cmp_idx = 1 << 30``) and
reads them with ``jnp.take(mode="fill")``, which returns zeros. PyTorch
indexing raises (or, in a kernel, reads out of bounds) on such indices,
so every such gather here clamps the index and zeroes the rows whose
index was out of range.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from gnn_tpu_torch.ops import sparse as sparse_ops
from gnn_tpu_torch.parallel.dist import PartGroup, part_sum_


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class HotSpec:
    """Host-side description of the hot node set: ``hot_nodes[s]`` = node
    of slot ``s`` (descending ``sample_prob``), ``slot_of_node[v]`` = slot
    of node ``v`` or -1; ``k`` = slot count padded to a multiple of 128."""

    hot_nodes: np.ndarray      # int64 [k_used]
    slot_of_node: np.ndarray   # int32 [N], -1 = cold
    k: int

    @staticmethod
    def from_sample_prob(sample_prob: np.ndarray, k: int) -> "HotSpec":
        k_used = min(k, len(sample_prob))
        hot = np.argsort(-sample_prob, kind="stable")[:k_used]
        slot = np.full(len(sample_prob), -1, np.int32)
        slot[hot] = np.arange(k_used, dtype=np.int32)
        return HotSpec(hot_nodes=hot.astype(np.int64), slot_of_node=slot,
                       k=_round_up(max(k_used, 1), 128))


def _densify(k, rows, cols, vals, dtype, device):
    d = torch.zeros((k, k), dtype=dtype, device=device)
    d[torch.as_tensor(rows, dtype=torch.long, device=device),
      torch.as_tensor(cols, dtype=torch.long, device=device)] = \
        torch.as_tensor(np.asarray(vals, np.float32), device=device
                        ).to(dtype)
    return d, d.t().contiguous()


def build_hot_dense(lap: sp.csr_matrix, spec: HotSpec,
                    dtype=torch.float32, device="cpu"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The resident ``[k, k]`` block ``lap[H][:, H]`` and its transpose,
    built on ``device``."""
    sub = lap[spec.hot_nodes, :][:, spec.hot_nodes].tocoo()
    return _densify(spec.k, sub.row, sub.col, sub.data, dtype, device)


def hot_coo_cached(lap: sp.csr_matrix, spec: HotSpec,
                   cache_path: Optional[str] = None):
    """``(rows, cols, vals)`` of the CSR double slice ``lap[H][:, H]``,
    cached on disk (validated against the exact hot node set)."""
    if cache_path and os.path.exists(cache_path):
        try:
            z = np.load(cache_path)
            if np.array_equal(z["hot_nodes"], spec.hot_nodes):
                return z["rows"], z["cols"], z["vals"]
        except (OSError, ValueError, KeyError) as e:
            print(f"hot cache {cache_path} unusable ({e}); rebuilding",
                  flush=True)
    sub = lap[spec.hot_nodes, :][:, spec.hot_nodes].tocoo()
    if cache_path:
        tmp = cache_path + ".tmp"
        with open(tmp, "wb") as f:  # keep np.savez from appending .npz
            np.savez(f, hot_nodes=spec.hot_nodes,
                     rows=sub.row.astype(np.int32),
                     cols=sub.col.astype(np.int32),
                     vals=sub.data.astype(np.float32))
        os.replace(tmp, cache_path)
    return sub.row, sub.col, sub.data


def build_hot_dense_cached(lap: sp.csr_matrix, spec: HotSpec,
                           dtype=torch.float32, device="cpu",
                           cache_path: Optional[str] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`build_hot_dense` with the slice cached (:func:`hot_coo_cached`)."""
    return _densify(spec.k, *hot_coo_cached(lap, spec, cache_path), dtype,
                    device)


def build_hot_dense_shard(lap: sp.csr_matrix, spec: HotSpec, part_rank: int,
                          n_parts: int, dtype=torch.float32, device="cpu",
                          cache_path: Optional[str] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Part ``part_rank``'s slot-column shards of the blocks,
    ``D[:, lo:hi]`` and ``D^T[:, lo:hi]`` (``= D[lo:hi, :]^T``), each
    ``[k, k / n_parts]``, built on ``device`` from the cached COO:
    nothing ``[k, k]`` is made there."""
    k = spec.k
    if k % n_parts:
        raise ValueError(f"hot slot count k={k} (a multiple of 128) "
                         f"must divide by n_parts={n_parts}")
    ksh = k // n_parts
    lo = part_rank * ksh
    rows, cols, vals = (np.asarray(a) for a in
                        hot_coo_cached(lap, spec, cache_path))
    vals = np.asarray(vals, np.float32)

    def block(r, c, sel):
        d = torch.zeros((k, ksh), dtype=dtype, device=device)
        d[torch.as_tensor(r[sel], dtype=torch.long, device=device),
          torch.as_tensor(c[sel] - lo, dtype=torch.long, device=device)] = \
            torch.as_tensor(vals[sel], device=device).to(dtype)
        return d
    return (block(rows, cols, (cols >= lo) & (cols < lo + ksh)),
            block(cols, rows, (rows >= lo) & (rows < lo + ksh)))


@dataclasses.dataclass
class HotDenseAdj:
    """One sampled layer split into resident-hot + cold parts (local
    index spaces as :class:`~gnn_tpu_torch.ops.sparse.COOAdj`: rows index
    the layer's output set, cols its input set)."""

    # cold residual as COO (zero-length when the edge-stream tiles carry
    # it); rows_t/cols_t/vals_t are its col-sorted copy (host pack) or the
    # same arrays (resident rebuild, ``t_sorted`` False)
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    rows_t: torch.Tensor
    cols_t: torch.Tensor
    vals_t: torch.Tensor
    # hot-slot plumbing
    colpos: torch.Tensor       # int32 [k]; local col of slot, ncols if absent
    nfh: torch.Tensor          # f32 [k]; normfact at that col (0 if absent)
    rowpos: torch.Tensor       # int32 [k]; local row of slot, nrows if absent
    nf_col: torch.Tensor       # f32 [ncols]; normfact where col is hot else 0
    # batch-present compaction (only hot slots actually sampled)
    present_row_slots: torch.Tensor  # int32 [rh_pad]
    row_cmp_idx: torch.Tensor        # int32 [nrows]; 1 << 30 = absent
    present_col_slots: torch.Tensor  # int32 [ch_pad]
    col_cmp_idx: torch.Tensor        # int32 [ncols]; 1 << 30 = absent
    n_valid_rows: int
    n_valid_cols: int
    dense: Optional[torch.Tensor]    # [k, k] resident block
    dense_t: Optional[torch.Tensor]  # [k, k] resident transpose
    nrows: int
    ncols: int
    k: int
    # False when rows_t/cols_t/vals_t are the forward arrays (no
    # col-sorted copy)
    t_sorted: bool = True
    # edge-stream tile payload for the cold residual (None = COO path)
    es_coords: Optional[torch.Tensor] = None  # int16 [n_cr, EC]
    es_rc: Optional[torch.Tensor] = None      # int32 [nb]
    es_off: Optional[torch.Tensor] = None     # int32 [2, nb + 1]
    es_ord: Optional[torch.Tensor] = None     # int32 [nb]
    es_vals: Optional[torch.Tensor] = None    # f32 [n_cr, EC]
    es_rv: Optional[torch.Tensor] = None      # f32 [nrows] row factors
    es_nf: Optional[torch.Tensor] = None      # f32 [ncols] col factors
    es_bm: int = 128
    es_bk: int = 0
    # part-sharded resident state: ``dense`` / ``dense_t`` are this
    # part's [k, k/P] slot-column shards and the hot products sum over
    # the part group; ``cold_partial``: the cold COO holds only this
    # part's rows (sharded full expansion) and its product sums too
    part_axis: Optional[PartGroup] = None
    cold_partial: bool = False

    @property
    def shape(self):
        return (self.nrows, self.ncols)


def _pad_sorted_coo(r, c, v, nnz_pad, pad_row, ridx, cidx):
    rr = np.full(nnz_pad, pad_row, ridx)
    cc = np.zeros(nnz_pad, cidx)
    vv = np.zeros(nnz_pad, np.float32)
    rr[: len(r)] = r
    cc[: len(c)] = c
    vv[: len(v)] = v
    return rr, cc, vv


def pack_hotdense(spec: HotSpec, rows: np.ndarray, cols: np.ndarray,
                  vals: np.ndarray, prev: np.ndarray, after: np.ndarray,
                  normfact: np.ndarray, n_valid_rows: int,
                  n_valid_cols: int, nrows_pad: int, ncols_pad: int,
                  nnz_pad: Optional[int] = None,
                  compress: bool = True) -> HotDenseAdj:
    """Split a sampled layer's COO into hot-block plumbing + the cold COO
    and its col-sorted transpose copy (numpy, the JAX package's arrays;
    ``compress`` keeps bfloat16-rounded values in float32).

    ``rows``/``cols`` are row-sorted local indices into ``prev``/
    ``after``; ``vals`` already carry ``lap_val * normfact[col]``. The
    split runs in the native core when it loads and ``vals`` is float32,
    else in numpy/scipy."""
    from gnn_tpu_torch.sampling.ladies import bucket_size

    prev_slots = spec.slot_of_node[prev]
    after_slots = spec.slot_of_node[after]

    colpos = np.full(spec.k, ncols_pad, np.int32)
    nfh = np.zeros(spec.k, np.float32)
    hot_c = np.flatnonzero(after_slots >= 0)
    colpos[after_slots[hot_c]] = hot_c
    nfh[after_slots[hot_c]] = normfact[hot_c]
    nf_col = np.zeros(ncols_pad, np.float32)
    nf_col[hot_c] = normfact[hot_c]

    rowpos = np.full(spec.k, nrows_pad, np.int32)
    hot_r = np.flatnonzero(prev_slots >= 0)
    rowpos[prev_slots[hot_r]] = hot_r

    # batch-present compaction; absent rows/cols read a fixed far
    # out-of-range sentinel
    sentinel = np.int32(1 << 30)
    rh_pad = bucket_size(max(len(hot_r), 1), 128)
    present_row_slots = np.zeros(rh_pad, np.int32)
    present_row_slots[: len(hot_r)] = prev_slots[hot_r]
    row_cmp_idx = np.full(nrows_pad, sentinel, np.int32)
    row_cmp_idx[hot_r] = np.arange(len(hot_r), dtype=np.int32)
    ch_pad = bucket_size(max(len(hot_c), 1), 128)
    present_col_slots = np.zeros(ch_pad, np.int32)
    present_col_slots[: len(hot_c)] = after_slots[hot_c]
    col_cmp_idx = np.full(ncols_pad, sentinel, np.int32)
    col_cmp_idx[hot_c] = np.arange(len(hot_c), dtype=np.int32)

    # cold extraction keeps the sampler's row order; the col-sorted copy
    # is a counting sort (native) or scipy's COO -> CSC
    hot_r_flag = prev_slots >= 0
    hot_c_flag = after_slots >= 0
    lib = None
    if np.asarray(vals).dtype == np.float32:
        from gnn_tpu_torch import native as _native
        lib = _native.get_lib()
    if lib is not None:
        from gnn_tpu_torch.native import hot_split_native
        cr, cc, cv, cr_s, cc_s, cv_s = hot_split_native(
            lib, rows, cols, vals, hot_r_flag, hot_c_flag, ncols_pad)
    else:
        hot_edge = hot_r_flag[rows] & hot_c_flag[cols]
        cold = np.flatnonzero(~hot_edge)
        cr, cc, cv = rows[cold], cols[cold], vals[cold]
        if len(cr):
            csc = sp.csc_matrix(
                (cv, (cr.astype(np.int64), cc.astype(np.int64))),
                shape=(nrows_pad, ncols_pad))
            cc_s = np.repeat(np.arange(ncols_pad, dtype=np.int64),
                             np.diff(csc.indptr))
            cr_s, cv_s = csc.indices, csc.data
        else:
            cc_s = cr_s = cv_s = np.zeros(0, np.int64)
    if len(cr) and not np.all(np.diff(cr) >= 0):
        raise ValueError("pack_hotdense expects row-sorted input edges")
    if nnz_pad is None:
        nnz_pad = bucket_size(max(len(cr), 1))
    ridx = np.int16 if (compress and nrows_pad <= 32768) else np.int32
    cidx = np.int16 if (compress and ncols_pad <= 32768) else np.int32
    if compress:
        from gnn_tpu_torch.ops.sparse import round_bf16
        cv, cv_s = round_bf16(cv), round_bf16(cv_s)
    rr, ccol, vv = _pad_sorted_coo(cr, cc, cv, nnz_pad, nrows_pad - 1,
                                   ridx, cidx)
    # the transpose copy's segment ids (cols) pad at the top end too
    ct, rt, vt = _pad_sorted_coo(cc_s, cr_s, cv_s, nnz_pad, ncols_pad - 1,
                                 cidx, ridx)
    return HotDenseAdj(
        rows=rr, cols=ccol, vals=vv, rows_t=rt, cols_t=ct, vals_t=vt,
        colpos=colpos, nfh=nfh, rowpos=rowpos, nf_col=nf_col,
        present_row_slots=present_row_slots, row_cmp_idx=row_cmp_idx,
        present_col_slots=present_col_slots, col_cmp_idx=col_cmp_idx,
        n_valid_rows=int(n_valid_rows), n_valid_cols=int(n_valid_cols),
        dense=None, dense_t=None, nrows=int(nrows_pad),
        ncols=int(ncols_pad), k=spec.k)


def bind_dense(adjs: List[object], dense, dense_t) -> List[object]:
    """A new adjacency list whose hot layers carry the resident blocks
    (the shipped layers never hold them)."""
    return [dataclasses.replace(a, dense=dense, dense_t=dense_t)
            if isinstance(a, HotDenseAdj) else a for a in adjs]


def _take_rows_fill(a: torch.Tensor, idx: torch.Tensor,
                    fill: float = 0.0) -> torch.Tensor:
    """``a[idx]`` with ``fill`` where ``idx`` is out of range (the JAX
    package's ``jnp.take(mode="fill", fill_value=fill)``)."""
    idx = idx.long()
    ok = (idx >= 0) & (idx < a.shape[0])
    rows = a.index_select(0, idx.clamp(0, max(a.shape[0] - 1, 0)))
    return torch.where(ok[:, None], rows, torch.full((), fill, dtype=a.dtype,
                                                     device=a.device))


def _hot_mm(d_rows: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``d_rows @ b`` with ``b`` rounded to the block's dtype and float32
    products and sums (JAX: ``preferred_element_type=float32``). A
    bfloat16 block on the card multiplies in bfloat16 with a float32
    result (``aten::mm.dtype``); elsewhere both operands upcast, which
    gives the same products exactly."""
    b = b.to(d_rows.dtype)
    if d_rows.dtype == torch.float32:
        return d_rows @ b
    if d_rows.is_cuda:
        return torch.mm(d_rows, b, out_dtype=torch.float32)
    return d_rows.float() @ b.float()


def _slot_range(adj: HotDenseAdj, block: torch.Tensor, *tables):
    """``tables`` cut to this part's slot range (the block's columns);
    whole where the block is not sharded."""
    if adj.part_axis is None:
        return tables
    ksh = block.shape[1]
    lo = adj.part_axis.rank * ksh
    return tuple(t[lo:lo + ksh] for t in tables)


def hot_block_forward(adj: HotDenseAdj, dense: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """The resident-block half of ``A @ x`` (no cold residual); on a
    sharded block, this part's slot range and one sum over the part
    group."""
    colpos, nfh = _slot_range(adj, dense, adj.colpos, adj.nfh)
    xh = _take_rows_fill(x, colpos) * nfh[:, None].to(x.dtype)
    d_rows = dense.index_select(0, adj.present_row_slots.long())
    yh_c = _hot_mm(d_rows, xh)
    part_sum_([yh_c], adj.part_axis)
    return _take_rows_fill(yh_c, adj.row_cmp_idx).to(x.dtype)


def hot_block_transpose(adj: HotDenseAdj, dense_t: torch.Tensor,
                        g: torch.Tensor) -> torch.Tensor:
    """The resident-block half of ``A^T @ g`` (no cold residual),
    symmetric to :func:`hot_block_forward`."""
    rowpos, = _slot_range(adj, dense_t, adj.rowpos)
    gh = _take_rows_fill(g, rowpos)
    dt_rows = dense_t.index_select(0, adj.present_col_slots.long())
    dh_c = _hot_mm(dt_rows, gh)
    part_sum_([dh_c], adj.part_axis)
    dx_hot = _take_rows_fill(dh_c, adj.col_cmp_idx)
    return (dx_hot * adj.nf_col[:, None]).to(g.dtype)


def _cold_edge_stream(adj: HotDenseAdj, u: torch.Tensor,
                      transpose: bool) -> torch.Tensor:
    """Cold residual through the edge-stream kernel (one packed coord
    buffer serves both directions)."""
    from gnn_tpu_torch.ops.edgestream import (ECAP, EdgeTiles,
                                              edge_stream_spmm)
    tiles = EdgeTiles(coords=adj.es_coords, blk_rc=adj.es_rc,
                      off=adj.es_off, t_order=adj.es_ord,
                      nrows=adj.nrows, ncols=adj.ncols, bm=adj.es_bm,
                      bk=adj.es_bk, ecap=ECAP, vals=adj.es_vals)
    return edge_stream_spmm(tiles, u, adj.es_rv, adj.es_nf,
                            transpose=transpose)


def hot_forward(adj: HotDenseAdj, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` with A = resident hot block + cold residual."""
    assert adj.dense is not None, "HotDenseAdj.dense is unbound"
    if adj.es_rc is not None:
        y = _cold_edge_stream(adj, x, transpose=False)
    else:
        y = sparse_ops._coo_aggregate(adj.rows, adj.cols, adj.vals, x,
                                      adj.nrows)
    if adj.cold_partial:
        # each part aggregated only the cold edges of the rows it owns
        part_sum_([y], adj.part_axis)
    return y + hot_block_forward(adj, adj.dense, x)


def hot_transpose(adj: HotDenseAdj, g: torch.Tensor) -> torch.Tensor:
    """``dx = A^T @ g`` — the backward aggregation."""
    assert adj.dense_t is not None, "HotDenseAdj.dense_t is unbound"
    if adj.es_rc is not None:
        dx = _cold_edge_stream(adj, g, transpose=True)
    else:
        dx = sparse_ops._coo_aggregate(adj.cols_t, adj.rows_t, adj.vals_t,
                                       g, adj.ncols)
    if adj.cold_partial:
        part_sum_([dx], adj.part_axis)
    return dx + hot_block_transpose(adj, adj.dense_t, g)
