"""Sparse neighborhood aggregation: the PyTorch counterpart of
`gnn_tpu.ops.sparse`.

* :class:`COOAdj` — the padded COO adjacency of one sampled layer, packed
  on the host by :func:`pack_coo` into the same arrays the JAX package
  packs (numpy), moved to the device by :func:`to_device`.
* :class:`BlockedAdj` — the tiled block-sparse layout: the occupied
  ``(bm, bk)`` tiles of each row tile, padded per row tile with zero
  tiles at column tile 0, plus the same layout of ``A^T`` for the
  backward (:func:`pack_blocked`). Aggregation runs through
  :func:`~gnn_tpu_torch.ops.spmm.blocked_spmm`: the hand-written
  stream-SpMM CUDA kernel (K2) on CUDA tensors, its plain version on CPU
  tensors.
* :class:`PatternAdj` — GAT's pattern-only transport (int16 cols + per-row
  counts, :func:`pack_pattern`); :meth:`PatternAdj.expand` rebuilds the
  rows on the device.
* :func:`_coo_aggregate` — ``y[r] = sum_e vals[e] * x[cols[e]]`` as a
  chunked ``index_add_`` (chunking bounds the ``[chunk, F]`` gather
  temporary, like the JAX ``lax.scan`` over ``_COO_CHUNK`` edges).
* :func:`spmm` — ``y = A @ x`` as a ``torch.autograd.Function`` whose
  backward is the transpose aggregation ``dx = A^T @ dy``; the adjacency
  gets no gradient (reference ``custom_sparse_ops.py:31-37``).
* :func:`to_dense` — the padded adjacency as a dense matrix (tests).

The resident hot-block adjacency (:class:`~gnn_tpu_torch.ops.hotdense.
HotDenseAdj`) dispatches to `gnn_tpu_torch.ops.hotdense`, whose cold
residual runs the hand-written edge-stream CUDA kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gnn_tpu_torch.ops.spmm import blocked_spmm


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def round_bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bfloat16 precision, kept as float32.

    The JAX package ships compressed values as numpy bfloat16 (an
    ml_dtypes type numpy alone lacks); the port keeps the same rounded
    values in float32 arrays, so both packages aggregate the same
    numbers."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


@dataclasses.dataclass
class COOAdj:
    """Padded COO adjacency for one sampled layer (pad edges: row
    ``nrows - 1``, col 0, val 0 — zero values make padding a no-op)."""

    rows: object               # int16/int32 [nnz_pad]
    cols: object               # int16/int32 [nnz_pad]
    vals: object               # f32 [nnz_pad]
    n_valid_rows: int
    n_valid_cols: int
    nrows: int
    ncols: int
    rows_sorted: bool = False

    @property
    def shape(self):
        return (self.nrows, self.ncols)


def pack_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
             n_valid_rows: int, n_valid_cols: int, nrows_pad: int,
             ncols_pad: int, nnz_pad: Optional[int] = None,
             compress: bool = False) -> COOAdj:
    """Pack host COO arrays into a padded :class:`COOAdj` (numpy).

    ``compress=True`` uses int16 indices where the padded shape fits and
    bfloat16-rounded values (see :func:`round_bf16`), as the JAX package
    does."""
    nnz = len(rows)
    if nnz_pad is None:
        nnz_pad = max(_round_up(max(nnz, 1), 512), 512)
    if nnz > nnz_pad:
        raise ValueError(f"nnz {nnz} exceeds pad {nnz_pad}")
    ridx = np.int16 if (compress and nrows_pad <= 32768) else np.int32
    cidx = np.int16 if (compress and ncols_pad <= 32768) else np.int32
    r = np.empty(nnz_pad, ridx)
    c = np.empty(nnz_pad, cidx)
    v = np.empty(nnz_pad, np.float32)
    r[:nnz] = rows
    c[:nnz] = cols
    v[:nnz] = round_bf16(vals) if compress else vals
    # pad rows sit at the LAST row so row-sorted inputs stay sorted
    r[nnz:] = nrows_pad - 1
    c[nnz:] = 0
    v[nnz:] = 0
    rows_sorted = bool(nnz == 0 or np.all(np.diff(rows) >= 0))
    return COOAdj(rows=r, cols=c, vals=v, n_valid_rows=int(n_valid_rows),
                  n_valid_cols=int(n_valid_cols), nrows=int(nrows_pad),
                  ncols=int(ncols_pad), rows_sorted=rows_sorted)


@dataclasses.dataclass
class BlockedAdj:
    """Tiled block-sparse adjacency (both A and A^T tilings).

    ``block_cols[i, b]`` = column tile of the b-th stored tile of row
    tile i, ``block_vals[i, b]`` its dense ``(bm, bk)`` contents; each row
    tile is padded to ``max_blk`` with all-zero tiles at column tile 0.
    The ``*_t`` fields hold the same structure for A^T."""

    block_cols: object     # int32 [n_row_tiles, max_blk]
    block_vals: object     # f32 [n_row_tiles, max_blk, bm, bk]
    block_cols_t: object   # int32 [n_col_tiles, max_blk_t]
    block_vals_t: object   # f32 [n_col_tiles, max_blk_t, bk, bm]
    n_valid_rows: int
    n_valid_cols: int
    nrows: int
    ncols: int
    bm: int
    bk: int

    @property
    def shape(self):
        return (self.nrows, self.ncols)


@dataclasses.dataclass
class PatternAdj:
    """Pattern-only adjacency for attention models (GAT): row-sorted
    int16/int32 cols + per-row counts; the values are computed on the
    device and never ship."""

    cols: object        # int16/int32 [nnz_pad]
    row_cnt: object     # int32 [nrows]: edges per output row
    n_edges: int        # valid edge count
    n_valid_rows: int
    n_valid_cols: int
    nrows: int
    ncols: int

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def nnz_pad(self) -> int:
        return self.cols.shape[0]

    def expand(self):
        """``(rows int64 [nnz_pad], cols int64, live bool)`` on the
        device: rows re-expand from the per-row counts; pad edges sit at
        the last row with ``live`` False."""
        nnz_pad = self.cols.shape[0]
        dev = self.cols.device
        live = torch.arange(nnz_pad, device=dev) < self.n_edges
        cnt = self.row_cnt.long()
        starts = torch.cumsum(cnt, 0) - cnt
        seg = torch.zeros(nnz_pad + 1, dtype=torch.long, device=dev)
        seg.index_add_(0, starts, torch.ones_like(starts))
        rows = torch.cumsum(seg[:nnz_pad], 0) - 1
        rows = torch.where(live, rows.clamp(0, self.nrows - 1),
                           torch.full_like(rows, self.nrows - 1))
        return rows, self.cols.long(), live


def pack_pattern(rows: np.ndarray, cols: np.ndarray, n_valid_rows: int,
                 n_valid_cols: int, nrows_pad: int, ncols_pad: int,
                 nnz_pad: Optional[int] = None,
                 compress: bool = True) -> PatternAdj:
    """Pack a row-sorted edge pattern into a :class:`PatternAdj` (numpy)."""
    nnz = len(rows)
    assert nnz == 0 or np.all(np.diff(rows) >= 0), \
        "pack_pattern expects row-sorted edges"
    if nnz_pad is None:
        nnz_pad = max(_round_up(max(nnz, 1), 512), 512)
    if nnz > nnz_pad:
        raise ValueError(f"nnz {nnz} exceeds pad {nnz_pad}")
    cidx = np.int16 if (compress and ncols_pad <= 32768) else np.int32
    c = np.zeros(nnz_pad, cidx)
    c[:nnz] = cols
    row_cnt = np.bincount(np.asarray(rows, np.int64),
                          minlength=nrows_pad).astype(np.int32) if nnz \
        else np.zeros(nrows_pad, np.int32)
    return PatternAdj(cols=c, row_cnt=row_cnt, n_edges=int(nnz),
                      n_valid_rows=int(n_valid_rows),
                      n_valid_cols=int(n_valid_cols), nrows=int(nrows_pad),
                      ncols=int(ncols_pad))


def _pack_blocks_one_side(rows, cols, vals, n_tiles_r, n_tiles_c, bm, bk,
                          max_blk=None):
    """Group COO edges into (bm, bk) dense tiles: ``(block_cols [n_tiles_r,
    max_blk] int32, block_vals [n_tiles_r, max_blk, bm, bk] f32)``."""
    tr = rows // bm
    tc = cols // bk
    tile_key = tr.astype(np.int64) * n_tiles_c + tc
    order = np.argsort(tile_key, kind="stable")
    tile_key = tile_key[order]
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    uniq, counts = np.unique(tile_key, return_counts=True)
    n_occ = len(uniq)
    occ_tr = (uniq // n_tiles_c).astype(np.int32)
    occ_tc = (uniq % n_tiles_c).astype(np.int32)
    blk_per_rt = np.bincount(occ_tr, minlength=n_tiles_r)
    need = int(blk_per_rt.max()) if n_occ else 1
    if max_blk is None:
        max_blk = max(need, 1)
    elif need > max_blk:
        raise ValueError(f"row tile needs {need} blocks > pad {max_blk}")
    block_cols = np.zeros((n_tiles_r, max_blk), np.int32)
    block_vals = np.zeros((n_tiles_r, max_blk, bm, bk), np.float32)
    # slot of each occupied tile within its row tile (uniq is sorted by
    # (tr, tc), so the slots of one row tile are consecutive)
    slot = np.arange(n_occ) - np.searchsorted(occ_tr, occ_tr)
    block_cols[occ_tr, slot] = occ_tc
    blk_of_edge = np.repeat(np.arange(n_occ), counts)
    lr = rows_s - occ_tr[blk_of_edge] * bm
    lc = cols_s - occ_tc[blk_of_edge] * bk
    block_vals[occ_tr[blk_of_edge], slot[blk_of_edge], lr, lc] = vals_s
    return block_cols, block_vals


def pack_blocked(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 n_valid_rows: int, n_valid_cols: int, nrows_pad: int,
                 ncols_pad: int, bm: int = 128, bk: int = 128,
                 max_blk: Optional[int] = None,
                 max_blk_t: Optional[int] = None) -> BlockedAdj:
    """Pack host COO into the tiled block-sparse layout plus its
    transpose (numpy, float32 tiles)."""
    assert nrows_pad % bm == 0 and ncols_pad % bk == 0
    n_tr, n_tc = nrows_pad // bm, ncols_pad // bk
    assert n_tr < (1 << 15) and n_tc < (1 << 15), (n_tr, n_tc)
    bc, bv = _pack_blocks_one_side(rows, cols, vals, n_tr, n_tc, bm, bk,
                                   max_blk)
    bct, bvt = _pack_blocks_one_side(cols, rows, vals, n_tc, n_tr, bk, bm,
                                     max_blk_t)
    return BlockedAdj(block_cols=bc, block_vals=bv, block_cols_t=bct,
                      block_vals_t=bvt, n_valid_rows=int(n_valid_rows),
                      n_valid_cols=int(n_valid_cols), nrows=int(nrows_pad),
                      ncols=int(ncols_pad), bm=bm, bk=bk)


def to_device(obj, device):
    """Copy a host dataclass's numpy array fields to ``device`` as
    tensors (0-d arrays and numpy scalars become Python ints). Returns a
    new dataclass; ``None`` and non-dataclass objects pass through."""
    if obj is None or not dataclasses.is_dataclass(obj):
        return obj
    fields = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray) and v.ndim == 0:
            fields[f.name] = v.item()
        elif isinstance(v, np.generic):
            fields[f.name] = v.item()
        elif isinstance(v, np.ndarray):
            fields[f.name] = torch.from_numpy(
                np.ascontiguousarray(v)).to(device)
    return dataclasses.replace(obj, **fields)


# Edge-chunk size: bounds the [chunk, F] gather temporary.
_COO_CHUNK = 262_144


def _coo_aggregate(rows, cols, vals, x: torch.Tensor, nrows: int
                   ) -> torch.Tensor:
    """``y[r] = sum_e vals[e] * x[cols[e]]`` over edges with
    ``rows[e] == r``, as chunked ``index_add_`` (sums in another order
    than XLA's segment-sum: equal to float32 rounding)."""
    rows = rows.long()
    cols = cols.long()
    y = torch.zeros((nrows, x.shape[1]), dtype=x.dtype, device=x.device)
    for s in range(0, rows.shape[0], _COO_CHUNK):
        r = rows[s:s + _COO_CHUNK]
        c = cols[s:s + _COO_CHUNK]
        v = vals[s:s + _COO_CHUNK].to(x.dtype)
        y.index_add_(0, r, x.index_select(0, c) * v[:, None])
    return y


def _forward(adj, x):
    from gnn_tpu_torch.ops import hotdense as _hot
    if isinstance(adj, _hot.HotDenseAdj):
        return _hot.hot_forward(adj, x)
    if isinstance(adj, COOAdj):
        return _coo_aggregate(adj.rows, adj.cols, adj.vals, x, adj.nrows)
    if isinstance(adj, BlockedAdj):
        return blocked_spmm(adj.block_cols, adj.block_vals, x, adj.bm,
                            adj.bk)
    raise TypeError(f"unknown adjacency type {type(adj)}")


def _transpose_forward(adj, g):
    from gnn_tpu_torch.ops import hotdense as _hot
    if isinstance(adj, _hot.HotDenseAdj):
        return _hot.hot_transpose(adj, g)
    if isinstance(adj, COOAdj):
        # A^T aggregation reuses the same COO with roles swapped
        return _coo_aggregate(adj.cols, adj.rows, adj.vals, g, adj.ncols)
    if isinstance(adj, BlockedAdj):
        # the host-packed transposed tiles: K2 forward over A^T
        return blocked_spmm(adj.block_cols_t, adj.block_vals_t, g, adj.bk,
                            adj.bm)
    raise TypeError(f"unknown adjacency type {type(adj)}")


def to_dense(adj) -> torch.Tensor:
    """The padded adjacency as a dense float32 ``[nrows, ncols]`` matrix
    on its device (tests / small problems)."""
    from gnn_tpu_torch.ops import hotdense as _hot
    if isinstance(adj, BlockedAdj):
        n_rt = adj.block_cols.shape[0]
        d = torch.zeros((n_rt, adj.ncols // adj.bk, adj.bm, adj.bk),
                        device=adj.block_vals.device)
        rt = torch.arange(n_rt, device=d.device)[:, None].expand_as(
            adj.block_cols)
        d.index_put_((rt, adj.block_cols.long()), adj.block_vals.float(),
                     accumulate=True)
        return d.permute(0, 2, 1, 3).reshape(adj.nrows, adj.ncols)
    d = torch.zeros((adj.nrows, adj.ncols), device=adj.rows.device)
    d.index_put_((adj.rows.long(), adj.cols.long()), adj.vals.float(),
                 accumulate=True)
    if isinstance(adj, COOAdj):
        return d
    if not isinstance(adj, _hot.HotDenseAdj):
        raise TypeError(f"unknown adjacency type {type(adj)}")
    assert adj.dense is not None, "HotDenseAdj.dense is unbound"
    if adj.es_rc is not None:
        from gnn_tpu_torch.ops.edgestream import ECAP, EdgeTiles, decode_edges
        r, c, w = decode_edges(EdgeTiles(
            coords=adj.es_coords, blk_rc=adj.es_rc, off=adj.es_off,
            t_order=adj.es_ord, nrows=adj.nrows, ncols=adj.ncols,
            bm=adj.es_bm, bk=adj.es_bk, ecap=ECAP, vals=adj.es_vals))
        d.index_put_((r, c), w * adj.es_rv[r] * adj.es_nf[c],
                     accumulate=True)
    # absent slots carry rowpos == nrows / colpos == ncols: they land in
    # the extra row / column, which is cut off (JAX: mode="drop")
    ext = torch.zeros((adj.nrows + 1, adj.ncols + 1), device=d.device)
    ext[:adj.nrows, :adj.ncols] = d
    hot = adj.dense.float() * adj.nfh[None, :]
    ri = adj.rowpos.long().clamp(max=adj.nrows)
    ci = adj.colpos.long().clamp(max=adj.ncols)
    ext.index_put_((ri[:, None].expand_as(hot), ci[None, :].expand_as(hot)),
                   hot, accumulate=True)
    return ext[:adj.nrows, :adj.ncols]


class _SpMM(torch.autograd.Function):
    """``y = A @ x``; backward ``dx = A^T @ dy``, no gradient to A."""

    @staticmethod
    def forward(ctx, adj, x):
        ctx.adj = adj
        return _forward(adj, x)

    @staticmethod
    def backward(ctx, g):
        dx = None
        if ctx.needs_input_grad[1]:
            dx = _transpose_forward(ctx.adj, g.contiguous())
        return None, dx


def spmm(adj, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` — sparse adjacency times dense features. Gradient
    flows to ``x`` only (``dx = A^T @ dy``)."""
    return _SpMM.apply(adj, x)


def spmm_transpose(adj, g: torch.Tensor) -> torch.Tensor:
    """``A^T @ g`` exposed directly (no autograd) for tests and
    inference."""
    return _transpose_forward(adj, g)
