"""Resident-graph minibatching — ship node ids, not edges: the PyTorch
counterpart of `gnn_tpu.ops.residentgraph`.

The hot-slot table, the rank-1 value factors and the hot blocks live on
the device (:class:`ResidentGraph`). Per step only the node sets, each
layer's LADIES debias vector and the cold residual ship
(:class:`ResidentLayerRef`, packed on the host by
:func:`pack_resident_ref` into the same arrays the JAX package packs);
:func:`materialize_adjs` rebuilds every layer's
:class:`~gnn_tpu_torch.ops.hotdense.HotDenseAdj` on the device.

Three payloads: the default "lite" mode's edge-stream tile payload
(packed coords for the CUDA kernel) and its forward cold COO, and full
expansion (``ship_cold=False``), where nothing per-edge ships and the
device rebuilds the cold COO from the resident CSR by span expansion,
column filter, hot/cold split and compaction.

The rebuild runs as well on one part's shard of the state
(`gnn_tpu_torch.parallel.shardedresident.ShardedResidentGraph`, which
answers the same lookups with a sum over the part group): the layers it
yields carry the part, and in full expansion each part expands only the
CSR rows it owns and marks the layer ``cold_partial``. A layer's slots
of its rows and columns come from one lookup (one collective on a
shard).

PyTorch has no counterpart of JAX's out-of-range index modes, so they
are spelled out: ``mode="fill"`` lookups index a table with one extra
sentinel entry, ``mode="drop"`` scatters write into one extra slot that
is then cut off, and ``mode="clip"`` clamps.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp
import torch

from gnn_tpu_torch.ops.hotdense import HotDenseAdj, HotSpec


@dataclasses.dataclass
class ResidentGraph:
    """Device-resident graph state (built once at setup, never shipped
    per step)."""

    row_ptr: torch.Tensor       # int32 [n + 1]
    col_idx: torch.Tensor       # int32 [e]
    val: torch.Tensor           # f32/bf16 [e] (laplacian data)
    slot_of_node: torch.Tensor  # int32 [n], hot slot or -1
    # rank-1 value factorization lap[r, c] = row_val[r] * col_val[c]
    row_val: torch.Tensor       # f32 [n]
    col_val: torch.Tensor       # f32 [n]
    dense: torch.Tensor         # [k, k] hot block
    dense_t: torch.Tensor       # [k, k] hot block transpose
    n: int
    k: int
    col_trivial: bool = True

    @staticmethod
    def from_host(host: dict, device) -> "ResidentGraph":
        """From :func:`build_resident_graph`'s dict (the host-only
        ``val_free`` flag is dropped)."""
        t = {f: (v if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(v))).to(device)
             for f, v in host.items()
             if f in ("row_ptr", "col_idx", "val", "slot_of_node",
                      "row_val", "col_val", "dense", "dense_t")}
        return ResidentGraph(**t, n=int(host["n"]), k=int(host["k"]),
                             col_trivial=bool(host["col_trivial"]))

    def state_bytes(self) -> dict:
        """Bytes of each resident tensor on the device."""
        out = {f: getattr(self, f).nbytes for f in
               ("slot_of_node", "row_val", "col_val", "dense", "dense_t")}
        out["csr"] = sum(t.nbytes for t in (self.row_ptr, self.col_idx,
                                            self.val))
        return out

    def slot_lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """Hot slot of each global node id (-1 = cold or id == n)."""
        ext = torch.cat([self.slot_of_node,
                         self.slot_of_node.new_full((1,), -1)])
        ids = ids.long()
        ids = torch.where((ids >= 0) & (ids < self.n), ids,
                          torch.full_like(ids, self.n))
        return ext.index_select(0, ids)

    def rowval_lookup(self, ids: torch.Tensor) -> torch.Tensor:
        return self.row_val.index_select(
            0, ids.long().clamp(0, self.n - 1))

    def colval_lookup(self, ids: torch.Tensor) -> torch.Tensor:
        return self.col_val.index_select(
            0, ids.long().clamp(0, self.n - 1))


def row_constant_values(lap: sp.csr_matrix):
    """``(row_val f32[N], True)`` when every row of ``lap`` holds one
    constant value on its support, else ``(zeros, False)``."""
    lap = lap.tocsr()
    n = lap.shape[0]
    rv = np.zeros(n, np.float32)
    lens = np.diff(lap.indptr)
    nz = lens > 0
    first = np.zeros(n, np.float32)
    first[nz] = lap.data[lap.indptr[:-1][nz]]
    expanded = np.repeat(first, lens)
    if not np.array_equal(expanded, lap.data.astype(np.float32)):
        return rv, False
    rv[nz] = first[nz]
    return rv, True


def rank1_values(lap: sp.csr_matrix):
    """Rank-1 factorization of a laplacian's values over its support:
    ``(row_val, col_val, col_trivial, ok)`` — row-normalized binary
    adjacencies (``col_val = 1``) or sym-normalized ones."""
    lap = lap.tocsr()
    n, m = lap.shape
    rv, const = row_constant_values(lap)
    if const:
        return rv, np.ones(m, np.float32), True, True
    deg_r = np.diff(lap.indptr).astype(np.float64)
    deg_c = np.bincount(lap.indices, minlength=m).astype(np.float64)
    with np.errstate(divide="ignore"):
        rf = np.where(deg_r > 0, 1.0 / np.sqrt(deg_r), 0.0)
    cf = np.where(deg_c > 0, 1.0 / np.sqrt(deg_c), 0.0)
    row_of = np.repeat(np.arange(n), np.diff(lap.indptr))
    recon = rf[row_of] * cf[lap.indices]
    if np.allclose(recon, lap.data.astype(np.float64), rtol=1e-6,
                   atol=0.0):
        return rf.astype(np.float32), cf.astype(np.float32), False, True
    return np.zeros(n, np.float32), np.ones(m, np.float32), True, False


def build_resident_graph(lap: sp.csr_matrix, spec: HotSpec, dense,
                         dense_t, val_dtype=np.float32) -> dict:
    """Host-side pieces of :class:`ResidentGraph` (``dense``/``dense_t``
    from ``build_hot_dense``). ``val_free`` is True when cold edge
    weights are device-derivable (rank-1 values). ``val_dtype``
    ``"bfloat16"`` keeps bfloat16-rounded values in float32."""
    lap = lap.tocsr()
    lap.sort_indices()
    rv, cv, col_trivial, ok = rank1_values(lap)
    val = lap.data.astype(np.float32)
    if isinstance(val_dtype, str) and val_dtype == "bfloat16":
        from gnn_tpu_torch.ops.sparse import round_bf16
        val = round_bf16(val)
    return dict(
        row_ptr=lap.indptr.astype(np.int32),
        col_idx=lap.indices.astype(np.int32),
        val=val,
        slot_of_node=spec.slot_of_node.astype(np.int32),
        row_val=rv, col_val=cv, dense=dense, dense_t=dense_t,
        n=int(lap.shape[0]), k=int(spec.k),
        col_trivial=col_trivial, val_free=ok)


@dataclasses.dataclass
class ResidentLayerRef:
    """The per-layer minibatch payload in resident mode: everything the
    device needs to rebuild the layer's HotDenseAdj except the node sets
    themselves."""

    normfact: object            # f32 [ncols]
    n_valid_rows: int
    n_valid_cols: int
    # lite COO payload: forward cold cols + per-row counts (+ values when
    # not val-free)
    rows: Optional[object] = None
    cols: Optional[object] = None      # int16/int32 [nnz_cold]
    vals: Optional[object] = None      # f32 [nnz_cold]
    row_cnt: Optional[object] = None   # int32 [nrows]
    n_cold: Optional[int] = None
    # edge-stream tile payload (replaces cols/row_cnt)
    es_coords: Optional[object] = None  # int16 [n_cr, EC]
    es_rc: Optional[object] = None      # int32 [nb]
    es_off: Optional[object] = None     # int32 [2, nb + 1]
    es_ord: Optional[object] = None     # int32 [nb]
    es_vals: Optional[object] = None    # f32 [n_cr, EC]
    nrows: int = 0
    ncols: int = 0
    e_cap: int = 0
    nnz_cold: int = 0
    rh_pad: int = 0
    ch_pad: int = 0
    es_bm: int = 128
    es_bk: int = 0

    @property
    def shape(self):
        return (self.nrows, self.ncols)


def pack_resident_ref(spec: HotSpec, lap_indptr, prev, after, normfact,
                      rows, cols, n_rows, n_cols, r_cap, c_cap,
                      vals=None, ship_cold: bool = True,
                      compress: bool = True,
                      cold_precomputed: bool = False,
                      val_free: bool = False,
                      stream_tiles: bool = False,
                      tiles_pre=None) -> ResidentLayerRef:
    """Host-side companion of the device rebuild (same arrays as the JAX
    package's; bfloat16 values are kept bfloat16-rounded in float32)."""
    from gnn_tpu_torch.ops.sparse import round_bf16
    from gnn_tpu_torch.sampling.ladies import bucket_size

    hot_r_flag = spec.slot_of_node[np.asarray(prev)] >= 0
    hot_c_flag = spec.slot_of_node[np.asarray(after)] >= 0
    if cold_precomputed:
        cr, cc, cv = rows, cols, vals
        n_cold = len(rows)
    elif len(rows):
        cold = ~(hot_r_flag[rows] & hot_c_flag[cols])
        n_cold = int(np.count_nonzero(cold))
        cr, cc, cv = rows[cold], cols[cold], vals[cold]
    else:
        cr = cc = np.zeros(0, np.int32)
        cv = np.zeros(0, np.float32)
        n_cold = 0
    nf = np.zeros(c_cap, np.float32)
    nf[: len(normfact)] = normfact
    rh_pad = bucket_size(max(int(hot_r_flag.sum()), 1), 128)
    ch_pad = bucket_size(max(int(hot_c_flag.sum()), 1), 128)
    if ship_cold and stream_tiles:
        from gnn_tpu_torch.ops.edgestream import (EC, ECAP, _build_tiles,
                                                  pack_edge_tiles,
                                                  repad_tiles, tile_dims)
        es_bm, es_bk = tile_dims(r_cap, c_cap)
        if tiles_pre is not None:
            # the native cold slice already emitted tile-grouped coords
            coords_s, tile_cnt, pre_bm, pre_bk = tiles_pre
            assert val_free
            assert (pre_bm, pre_bk) == (es_bm, es_bk)
            n_cold = len(coords_s)
            e_pad = bucket_size(max(n_cold, 1))
            occ = np.flatnonzero(tile_cnt)
            t = _build_tiles(coords_s, occ.astype(np.int64),
                             tile_cnt[occ].astype(np.int64), r_cap,
                             c_cap, es_bm, es_bk, ECAP, r_cap // es_bm,
                             c_cap // es_bk, None, e_pad)
        else:
            e_pad = bucket_size(max(n_cold, 1))
            assert e_pad % EC == 0, e_pad
            t = pack_edge_tiles(
                np.asarray(cr, np.int32), np.asarray(cc, np.int32),
                r_cap, c_cap, bm=es_bm, bk=es_bk, ecap=ECAP,
                e_pad=e_pad,
                vals=None if val_free else np.asarray(cv, np.float32),
                val_dtype=None if compress else np.float32)
        nb_pad = bucket_size(t.blk_rc.shape[0], 512)
        c2, rc2, off2, ord2, v2 = repad_tiles(
            t.coords, t.blk_rc, t.off, t.t_order, nb_pad,
            t.coords.shape[0], r_cap // es_bm, c_cap // es_bk,
            vals=t.vals)
        return ResidentLayerRef(
            normfact=nf, n_valid_rows=int(n_rows),
            n_valid_cols=int(n_cols), nrows=int(r_cap), ncols=int(c_cap),
            e_cap=0, nnz_cold=e_pad, rh_pad=rh_pad, ch_pad=ch_pad,
            es_coords=c2, es_rc=rc2, es_off=off2, es_ord=ord2,
            es_vals=v2, es_bm=es_bm, es_bk=es_bk)
    kw = {}
    if ship_cold:
        nnz_pad = bucket_size(max(n_cold, 1))
        cidx = np.int16 if (compress and c_cap <= 32768) else np.int32
        ccol = np.zeros(nnz_pad, cidx)
        ccol[: n_cold] = cc
        if n_cold:
            row_cnt = np.bincount(cr, minlength=r_cap).astype(np.int32)
        else:
            row_cnt = np.zeros(r_cap, np.int32)
        kw = dict(cols=ccol, row_cnt=row_cnt, n_cold=int(n_cold))
        if not val_free:
            vv = np.zeros(nnz_pad, np.float32)
            if n_cold:
                cvf = np.asarray(cv, np.float32)
                vv[: n_cold] = round_bf16(cvf) if compress else cvf
            kw["vals"] = vv
        e_cap = 0
    else:
        deg_sum = int(np.sum(lap_indptr[np.asarray(prev) + 1]
                             - lap_indptr[np.asarray(prev)]))
        e_cap = bucket_size(max(deg_sum, 1))
        nnz_pad = bucket_size(max(n_cold, 1))
    return ResidentLayerRef(
        normfact=nf, n_valid_rows=int(n_rows), n_valid_cols=int(n_cols),
        nrows=int(r_cap), ncols=int(c_cap), e_cap=e_cap,
        nnz_cold=nnz_pad, rh_pad=rh_pad, ch_pad=ch_pad, **kw)


def _scatter_drop(size: int, fill, idx: torch.Tensor, src, dtype,
                  device) -> torch.Tensor:
    """``full(size, fill).at[idx].set(src, mode="drop")``: out-of-range
    indices write into one extra slot that is cut off."""
    out = torch.full((size + 1,), fill, dtype=dtype, device=device)
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < size), idx,
                      torch.full_like(idx, size))
    if not isinstance(src, torch.Tensor):
        src = torch.full(idx.shape, src, dtype=dtype, device=device)
    out.index_put_((idx,), src.to(dtype))
    return out[:size]


def materialize_layer(g: ResidentGraph, ref: ResidentLayerRef,
                      row_ids: torch.Tensor, col_ids: torch.Tensor
                      ) -> HotDenseAdj:
    """Rebuild one layer's :class:`HotDenseAdj` on the device.
    ``row_ids``/``col_ids``: global node ids of the layer's output/input
    sets, padded to ``ref.nrows``/``ref.ncols``."""
    nrows, ncols = ref.nrows, ref.ncols
    n = g.n
    dev = row_ids.device
    valid_r = torch.arange(nrows, device=dev) < ref.n_valid_rows
    valid_c = torch.arange(ncols, device=dev) < ref.n_valid_cols
    rows_g = torch.where(valid_r, row_ids.long(),
                         torch.full_like(row_ids.long(), n))
    cols_g = torch.where(valid_c, col_ids.long(),
                         torch.full_like(col_ids.long(), n))

    def _nf_eff():
        if g.col_trivial:
            return ref.normfact
        return ref.normfact * g.colval_lookup(cols_g)

    if ref.es_rc is not None:
        # edge-stream tile payload: values recompute as rv[r] * nf_eff[c]
        # (val-free) or ride per edge in es_vals (factors are ones)
        z_i = torch.zeros(0, dtype=torch.int32, device=dev)
        z_f = torch.zeros(0, dtype=torch.float32, device=dev)
        if ref.es_vals is not None:
            es_rv = torch.ones(nrows, dtype=torch.float32, device=dev)
            es_nf = torch.ones(ncols, dtype=torch.float32, device=dev)
        else:
            es_rv = g.rowval_lookup(rows_g)
            es_nf = _nf_eff()
        return _finish_layer(g, ref, rows_g, cols_g, z_i, z_i, z_f,
                             es_rv=es_rv, es_nf=es_nf)

    if ref.cols is not None:
        # lite COO: local rows re-expand from per-row counts; val-free
        # weights recompute as row_val * normfact
        cc = ref.cols.long()
        nnz = ref.nnz_cold
        cold_valid = torch.arange(nnz, device=dev) < ref.n_cold
        if ref.row_cnt is not None:
            cnt = ref.row_cnt.long()
            starts = torch.cumsum(cnt, 0) - cnt
            seg = torch.zeros(nnz + 1, dtype=torch.long, device=dev)
            seg.index_add_(0, starts.clamp(max=nnz),
                           (starts <= nnz).long())
            rr = torch.cumsum(seg[:nnz], 0) - 1
            rr = torch.where(cold_valid, rr.clamp(0, nrows - 1),
                             torch.full_like(rr, nrows - 1))
        else:
            rr = ref.rows.long()
        if ref.vals is not None:
            vv = ref.vals.float()
        else:
            rowv = g.rowval_lookup(rows_g)
            vv = torch.where(cold_valid,
                             rowv.index_select(0, rr)
                             * _nf_eff().index_select(0, cc),
                             torch.zeros((), device=dev))
        return _finish_layer(g, ref, rows_g, cols_g, rr.int(), cc.int(),
                             vv)
    return _expand_layer(g, ref, rows_g, cols_g)


def _slots(g, rows_g, cols_g):
    """``(row slots, col slots)`` of a layer from one lookup."""
    both = g.slot_lookup(torch.cat([rows_g, cols_g]))
    return both[: rows_g.shape[0]], both[rows_g.shape[0]:]


def _expand_layer(g: ResidentGraph, ref: ResidentLayerRef, rows_g,
                  cols_g) -> HotDenseAdj:
    """Full expansion: the layer's cold COO from the resident CSR, in the
    order the host slice emits it (row-major, ascending column). On a
    part's shard, only the rows this part owns (the others read degree
    0), a partial COO whose product the part group sums."""
    nrows, ncols, n = ref.nrows, ref.ncols, g.n
    e_cap, nnz = ref.e_cap, ref.nnz_cold
    dev = rows_g.device
    sharded = getattr(g, "part", None) is not None
    if sharded:
        if g.row_ptr_shard is None:
            raise ValueError(
                "full-expansion resident mode on a part-sharded graph "
                "needs the row-range CSR shards: build the state with "
                "ship_csr=True (shard_resident_state)")
        rp_lo, deg = g.csr_spans(rows_g)
        col_src, val_src = g.col_idx_shard, g.val_shard
    else:
        # the rows' CSR spans; the pad row id n reads row_ptr[n] twice
        # (degree 0), as JAX's clipped take does
        rp_lo = g.row_ptr.long().index_select(0, rows_g.clamp(0, n))
        rp_hi = g.row_ptr.long().index_select(0, (rows_g + 1).clamp(0, n))
        deg = rp_hi - rp_lo
        col_src, val_src = g.col_idx, g.val
    e_tot = col_src.shape[0]
    starts = torch.cumsum(deg, 0) - deg
    e_used = starts[-1] + deg[-1]
    # local row of every edge slot: +1 at each row's first slot
    # (starts <= e_used <= e_cap, so every start lands in the e_cap + 1
    # table)
    seg = torch.zeros(e_cap + 1, dtype=torch.long, device=dev)
    seg.index_add_(0, starts.clamp(max=e_cap), torch.ones_like(starts))
    lr = (torch.cumsum(seg[:e_cap], 0) - 1).clamp(0, nrows - 1)
    slot = torch.arange(e_cap, device=dev)
    e_valid = slot < e_used
    eptr = rp_lo.index_select(0, lr) + (slot - starts.index_select(0, lr))
    # slots past the CSR read column 0 and value 0 (JAX: mode="fill")
    in_csr = (eptr >= 0) & (eptr < e_tot)
    eptr_c = eptr.clamp(0, max(e_tot - 1, 0))
    gcol = torch.where(in_csr, col_src.long().index_select(0, eptr_c),
                       torch.zeros_like(eptr))
    ev = torch.where(in_csr, val_src.float().index_select(0, eptr_c),
                     torch.zeros((), device=dev))
    # global -> local column table; pad columns (cols_g == n) land in the
    # extra entry n, which no edge's column reaches
    tab = torch.full((n + 1,), -1, dtype=torch.long, device=dev)
    tab[cols_g] = torch.arange(ncols, device=dev)
    lc = tab.index_select(0, gcol)
    keep = e_valid & (lc >= 0)
    lc_safe = torch.where(keep, lc, torch.zeros_like(lc))
    w = ev * ref.normfact.index_select(0, lc_safe)
    # hot-hot edges live in the resident block
    slots = _slots(g, rows_g, cols_g)
    r_hot, c_hot = (s >= 0 for s in slots)
    edge_hot = r_hot.index_select(0, lr) & c_hot.index_select(0, lc_safe)
    cold = keep & ~edge_hot
    # compact the cold edges (positions are monotone); pads sit at row
    # nrows - 1 with value 0, as pack_hotdense's
    pos = torch.cumsum(cold.long(), 0) - 1
    pos = torch.where(cold, pos, torch.full_like(pos, nnz))
    rr = _scatter_drop(nnz, nrows - 1, pos, lr, torch.int32, dev)
    cc = _scatter_drop(nnz, 0, pos, lc_safe, torch.int32, dev)
    vv = _scatter_drop(nnz, 0.0, pos, w, torch.float32, dev)
    return _finish_layer(g, ref, rows_g, cols_g, rr, cc, vv, slots=slots,
                         cold_partial=sharded)


def _finish_layer(g: ResidentGraph, ref: ResidentLayerRef, rows_g, cols_g,
                  rr, cc, vv, es_rv=None, es_nf=None, slots=None,
                  cold_partial: bool = False) -> HotDenseAdj:
    """Shared tail of the device rebuild: transpose arrays (the forward
    ones — no col-sorted copy) + all hot-slot plumbing. ``slots``: the
    rows' and columns' slots where the caller looked them up already."""
    nrows, ncols = ref.nrows, ref.ncols
    dev = rows_g.device
    k = g.k
    r_slot, c_slot = slots if slots is not None else _slots(g, rows_g,
                                                            cols_g)
    r_hot = r_slot >= 0
    c_hot = c_slot >= 0
    c_slot_safe = torch.where(c_hot, c_slot, torch.full_like(c_slot, k))
    colpos = _scatter_drop(k, ncols, c_slot_safe,
                           torch.arange(ncols, device=dev), torch.int32,
                           dev)
    nfh = _scatter_drop(k, 0.0, c_slot_safe, ref.normfact, torch.float32,
                        dev)
    r_slot_safe = torch.where(r_hot, r_slot, torch.full_like(r_slot, k))
    rowpos = _scatter_drop(k, nrows, r_slot_safe,
                           torch.arange(nrows, device=dev), torch.int32,
                           dev)
    nf_col = torch.where(c_hot, ref.normfact, torch.zeros((), device=dev))

    sentinel = 1 << 30
    rpos = torch.cumsum(r_hot.int(), 0) - 1
    row_cmp_idx = torch.where(r_hot, rpos, torch.full_like(rpos, sentinel))
    present_row_slots = _scatter_drop(
        ref.rh_pad, 0, torch.where(r_hot, rpos, torch.full_like(
            rpos, ref.rh_pad)), r_slot, torch.int32, dev)
    cpos = torch.cumsum(c_hot.int(), 0) - 1
    col_cmp_idx = torch.where(c_hot, cpos, torch.full_like(cpos, sentinel))
    present_col_slots = _scatter_drop(
        ref.ch_pad, 0, torch.where(c_hot, cpos, torch.full_like(
            cpos, ref.ch_pad)), c_slot, torch.int32, dev)

    es_kw = {}
    if es_rv is not None:
        es_kw = dict(es_coords=ref.es_coords, es_rc=ref.es_rc,
                     es_off=ref.es_off, es_ord=ref.es_ord,
                     es_vals=ref.es_vals, es_rv=es_rv,
                     es_nf=ref.normfact if es_nf is None else es_nf,
                     es_bm=ref.es_bm, es_bk=ref.es_bk)
    return HotDenseAdj(
        rows=rr, cols=cc, vals=vv, rows_t=rr, cols_t=cc, vals_t=vv,
        colpos=colpos, nfh=nfh, rowpos=rowpos, nf_col=nf_col,
        present_row_slots=present_row_slots,
        row_cmp_idx=row_cmp_idx.int(),
        present_col_slots=present_col_slots,
        col_cmp_idx=col_cmp_idx.int(),
        n_valid_rows=ref.n_valid_rows, n_valid_cols=ref.n_valid_cols,
        dense=g.dense, dense_t=g.dense_t, nrows=nrows, ncols=ncols, k=k,
        t_sorted=False, part_axis=getattr(g, "part", None),
        cold_partial=cold_partial, **es_kw)


def layer_ids(adjs, sampled_nodes, input_nodes):
    """Per layer, the global ids of its rows and columns (None for a
    layer that is not a `ResidentLayerRef`). Level sets chain upward
    from the global ``input_nodes``: layer l's rows are
    ``level_l[sampled_nodes[l]]``."""
    out = []
    level = input_nodes.long()
    for l, a in enumerate(adjs):
        if isinstance(a, ResidentLayerRef):
            idx = sampled_nodes[l].long().clamp(0, level.shape[0] - 1)
            row_ids = level.index_select(0, idx)
            out.append((row_ids, level))
            level = row_ids
        else:
            # order-0 layer (None): the node set is unchanged
            out.append(None)
    return out


def materialize_adjs(g: ResidentGraph, adjs, sampled_nodes,
                     input_nodes) -> List[Optional[HotDenseAdj]]:
    """Rebuild every resident layer of a batch (:func:`layer_ids`)."""
    return [a if ids is None else materialize_layer(g, a, *ids)
            for a, ids in zip(adjs, layer_ids(adjs, sampled_nodes,
                                              input_nodes))]
