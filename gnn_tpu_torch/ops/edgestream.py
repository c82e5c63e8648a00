"""Edge-stream SpMM: the cold-residual aggregation of the resident
hot-block path, from `gnn_tpu.ops.pallas_edgestream`.

Host side (numpy, identical arrays to the JAX package's): the packed
tile layout :class:`EdgeTiles` and its packers :func:`pack_edge_tiles`,
:func:`_build_tiles`, :func:`repad_tiles` and :func:`tile_dims`. Each
edge is one int16 ``(lr << log2 bk) | lc`` coordinate local to its
``(bm, bk)`` tile; entries ``blk_rc = rt << 16 | ct`` sorted rt-major own
at most ``ecap`` edges each; ``t_order`` visits the entries ct-major for
the transpose, so one packed buffer serves both directions.

Device side: :func:`edge_stream_spmm` computes
``y = rv * (A01 @ (nf * x))`` (or the transpose) by launching the
hand-written CUDA kernel ``gnn_tpu_torch/csrc/edge_stream.cu`` on CUDA
tensors. On CPU tensors it runs the plain PyTorch version
:func:`edge_stream_spmm_ref`, which decodes every edge to global
``(row, col)`` and aggregates with ``index_add_``.

The segment-grid variant (K6): :func:`segment_tiles` groups a pack's
entries into segments (runs of one row tile whose edges fit a fixed
coord window) and :func:`edge_stream_spmm_seg` computes the forward
product with one unit of parallel work per segment (plain version
:func:`edge_stream_spmm_seg_ref`). It is rank-1 only; its transpose is
the same call on a (cols, rows)-swapped pack with the factors swapped.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from gnn_tpu_torch.ops import cuda_build

# edges per coord row (the coord grid is [n_coord_rows, EC]) and the tail
# pad in coord rows the TPU kernel's two block views need; kept so the
# packed arrays stay identical to the JAX package's
EC = 256
BLK_ROWS = 8
# deployed per-entry edge cap (heavier tiles split across entries)
ECAP = 256

# kernel launches by direction ("forward" / "transpose") and of the
# segment-grid kernel ("seg"); incremented only where a CUDA kernel is
# launched. A launch recorded into a CUDA graph under capture counts in
# ``captured`` instead: it runs at each replay of the graph
# (`gnn_tpu_torch.train.dispatch` multiplies)
launches: collections.Counter = collections.Counter()
captured: collections.Counter = collections.Counter()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class EdgeTiles:
    """Tile-grouped edge stream for one sampled layer (both directions).

    Entry ``i`` owns flat edges ``[off[0, i], off[0, i] + off[1, i])``.
    Sentinel zero-edge entries make every row tile and col tile appear;
    pad entries point at tile ``(n_rt - 1, n_ct - 1)``, which sorts last
    in both orders. Arrays are numpy on the host and tensors on the
    device."""

    coords: object   # int16 [n_coord_rows, EC]
    blk_rc: object   # int32 [NB]
    off: object      # int32 [2, NB + 1]: row 0 = offset, 1 = count
    t_order: object  # int32 [NB]
    nrows: int
    ncols: int
    bm: int
    bk: int
    ecap: int
    # per-edge values in tile order, same grid as coords (None = the
    # rank-1 factors alone)
    vals: Optional[object] = None


def pack_edge_tiles(rows: np.ndarray, cols: np.ndarray, nrows_pad: int,
                    ncols_pad: int, bm: int = 128, bk: int = 128,
                    ecap: int = 256, nb_pad: Optional[int] = None,
                    e_pad: Optional[int] = None, use_native: bool = True,
                    vals: Optional[np.ndarray] = None,
                    val_dtype=None) -> EdgeTiles:
    """Host-side packing: COO pattern -> tile-grouped edge stream. The
    tile sort runs in the native core when it is available."""
    assert nrows_pad % bm == 0 and ncols_pad % bk == 0
    assert ecap <= BLK_ROWS * EC, (ecap, BLK_ROWS)
    assert (bm & (bm - 1)) == 0 and (bk & (bk - 1)) == 0, (bm, bk)
    assert bm * bk <= (1 << 16), (bm, bk)  # int16 coord pack
    n_rt, n_ct = nrows_pad // bm, ncols_pad // bk
    assert n_rt < (1 << 15) and n_ct < (1 << 16), (n_rt, n_ct)
    shift = bk.bit_length() - 1
    lib = None
    if use_native:
        from gnn_tpu_torch import native as _native
        lib = _native.get_lib()
    vals_s = None
    if lib is not None:
        if vals is not None:
            from gnn_tpu_torch.native import pack_tiles_perm_native
            coords_s, tile_cnt, perm = pack_tiles_perm_native(
                lib, np.asarray(rows, np.int32),
                np.asarray(cols, np.int32), n_rt, n_ct,
                bm.bit_length() - 1, shift)
            vals_s = np.asarray(vals)[perm]
        else:
            from gnn_tpu_torch.native import pack_tiles_native
            coords_s, tile_cnt = pack_tiles_native(
                lib, np.asarray(rows, np.int32),
                np.asarray(cols, np.int32), n_rt, n_ct,
                bm.bit_length() - 1, shift)
        occ = np.flatnonzero(tile_cnt)
        uniq = occ.astype(np.int64)
        counts = tile_cnt[occ].astype(np.int64)
    else:
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        key = (rows // bm) * n_ct + cols // bk
        order = np.argsort(key, kind="stable")
        rows_s, cols_s = rows[order], cols[order]
        if vals is not None:
            vals_s = np.asarray(vals)[order]
        uniq, counts = np.unique(key[order], return_counts=True)
        lr = rows_s - (rows_s // bm) * bm
        lc = cols_s - (cols_s // bk) * bk
        coords_s = (((lr << shift) | lc) & 0xFFFF).astype(
            np.uint16).view(np.int16)
    return _build_tiles(coords_s, uniq, counts, nrows_pad, ncols_pad,
                        bm, bk, ecap, n_rt, n_ct, nb_pad, e_pad,
                        vals_s=vals_s, val_dtype=val_dtype)


def _build_tiles(coords_s: np.ndarray, uniq: np.ndarray,
                 counts: np.ndarray, nrows_pad: int, ncols_pad: int,
                 bm: int, bk: int, ecap: int, n_rt: int, n_ct: int,
                 nb_pad: Optional[int], e_pad: Optional[int],
                 vals_s: Optional[np.ndarray] = None,
                 val_dtype=None) -> EdgeTiles:
    """Entry tables + padding from tile-sorted coords and per-tile
    counts. ``val_dtype`` ``None`` (the JAX package's bfloat16 default)
    keeps bfloat16-rounded values in float32; ``np.float32`` keeps them
    as given."""
    # split heavy tiles into ceil(cnt/ecap) entries
    n_ent = np.maximum(-(-counts // ecap), 1)
    ent_tile = np.repeat(np.arange(len(uniq)), n_ent)
    within = (np.arange(len(ent_tile))
              - np.repeat(np.cumsum(n_ent) - n_ent, n_ent))
    tile_start = np.concatenate([[0], np.cumsum(counts)])[:-1]
    ent_off = (tile_start[ent_tile] + within * ecap).astype(np.int64)
    ent_cnt = np.minimum(counts[ent_tile] - within * ecap, ecap)
    ent_rc = ((uniq[ent_tile] // n_ct).astype(np.int64) << 16) \
        | (uniq[ent_tile] % n_ct).astype(np.int64)

    # sentinel zero-edge entries for unvisited row-tiles / col-tiles
    miss_rt = np.setdiff1d(np.arange(n_rt), np.unique(uniq // n_ct))
    miss_ct = np.setdiff1d(np.arange(n_ct), np.unique(uniq % n_ct))
    sent_rc = np.concatenate([miss_rt.astype(np.int64) << 16,
                              miss_ct.astype(np.int64)])
    if len(sent_rc):
        ent_rc = np.concatenate([ent_rc, sent_rc])
        ent_off = np.concatenate(
            [ent_off, np.zeros(len(sent_rc), np.int64)])
        ent_cnt = np.concatenate(
            [ent_cnt, np.zeros(len(sent_rc), np.int64)])

    # forward visit order: (rt, ct); entries of one tile stay adjacent
    fwd = np.argsort(ent_rc, kind="stable")
    ent_rc, ent_off, ent_cnt = ent_rc[fwd], ent_off[fwd], ent_cnt[fwd]
    nb = len(ent_rc)
    if nb_pad is None:
        nb_pad = max(_round_up(nb, 8), 8)
    if nb > nb_pad:
        raise ValueError(f"{nb} entries > nb_pad {nb_pad}")

    e_used = len(coords_s)
    if e_pad is None:
        e_pad = max(_round_up(e_used, EC), EC)
    if e_used > e_pad:
        raise ValueError(f"{e_used} edges > e_pad {e_pad}")
    n_cr = e_pad // EC + 2 * BLK_ROWS
    coords = np.zeros(n_cr * EC, np.int16)
    coords[:e_used] = coords_s
    coords = coords.reshape(n_cr, EC)
    vgrid = None
    if vals_s is not None:
        vgrid = np.zeros(n_cr * EC, np.float32)
        v = np.asarray(vals_s, np.float32)
        if val_dtype is None:
            from gnn_tpu_torch.ops.sparse import round_bf16
            v = round_bf16(v)
        vgrid[:e_used] = v
        vgrid = vgrid.reshape(n_cr, EC)

    # pad entries carry zero edges and point at tile (n_rt-1, n_ct-1),
    # which sorts LAST in both visit orders
    pad_rc = ((n_rt - 1) << 16) | (n_ct - 1)
    blk_rc = np.full(nb_pad, pad_rc, np.int32)
    blk_rc[:nb] = ent_rc.astype(np.int32)
    offcnt = np.zeros((2, nb_pad + 1), np.int32)
    offcnt[0, :nb] = ent_off
    offcnt[1, :nb] = ent_cnt

    # transpose order: (ct, rt) over ALL nb_pad entries (pads sort last)
    t_key = ((blk_rc.astype(np.int64) & 0xFFFF) << 16) | \
        (blk_rc.astype(np.int64) >> 16)
    t_ord = np.argsort(t_key, kind="stable").astype(np.int32)

    return EdgeTiles(coords=coords, blk_rc=blk_rc, off=offcnt,
                     t_order=t_ord, nrows=int(nrows_pad),
                     ncols=int(ncols_pad), bm=bm, bk=bk, ecap=ecap,
                     vals=vgrid)


def tile_dims(nrows_pad: int, ncols_pad: int):
    """The deployed (bm, bk) choice for a layer's padded caps: 256 where
    the cap aligns, else 128 (one place, so the sampler's native slice
    and `pack_resident_ref` always agree)."""
    return (256 if nrows_pad % 256 == 0 else 128,
            256 if ncols_pad % 256 == 0 else 128)


def repad_tiles(coords: np.ndarray, blk_rc: np.ndarray, off: np.ndarray,
                t_order: np.ndarray, nb_pad: int, n_cr: int,
                n_rt: int, n_ct: int, vals: Optional[np.ndarray] = None):
    """Extend a packed tile set to (nb_pad entries, n_cr coord rows).
    Pad entries carry zero edges at tile (n_rt-1, n_ct-1), which sorts
    last in both visit orders. Returns ``(coords, blk_rc, off, t_order,
    vals)``."""
    nb = blk_rc.shape[0]
    if nb == nb_pad and coords.shape[0] == n_cr:
        return coords, blk_rc, off, t_order, vals
    assert nb_pad >= nb and n_cr >= coords.shape[0], \
        ((nb, nb_pad), (coords.shape[0], n_cr))
    pad_rc = ((n_rt - 1) << 16) | (n_ct - 1)
    blk2 = np.concatenate(
        [blk_rc, np.full(nb_pad - nb, pad_rc, np.int32)])
    off2 = np.zeros((2, nb_pad + 1), np.int32)
    off2[:, : nb + 1] = off
    t2 = np.concatenate(
        [t_order, np.arange(nb, nb_pad, dtype=np.int32)])
    c2 = np.zeros((n_cr, coords.shape[1]), coords.dtype)
    c2[: coords.shape[0]] = coords
    v2 = None
    if vals is not None:
        v2 = np.zeros((n_cr, vals.shape[1]), vals.dtype)
        v2[: vals.shape[0]] = vals
    return c2, blk2, off2, t2, v2


def segment_tiles(blk_rc: np.ndarray, off: np.ndarray,
                  ns_pad: Optional[int] = None) -> np.ndarray:
    """Group a tile set's entries into segments for the segment-grid
    kernel (K6). A segment is a maximal run of consecutive entries that
    share one row tile and whose edges fit the TPU kernel's coord window
    ``[base, base + 2 * BLK_ROWS * EC)`` anchored at its first entry.
    Every row tile gets a segment, even one that holds only its zero-edge
    sentinel; other zero-count entries never force a split. Returns
    ``seg_ptr`` int32 ``[ns_pad + 1]`` (entry-index boundaries; trailing
    padding segments start at ``nb`` and are empty)."""
    nb = blk_rc.shape[0]
    win = BLK_ROWS * EC
    rt = blk_rc.astype(np.int64) >> 16
    o = off[0, :nb].astype(np.int64)
    c = off[1, :nb].astype(np.int64)
    starts = [0]
    cur_base = (o[0] // win) if nb else 0
    for j in range(1, nb):
        if rt[j] != rt[starts[-1]]:
            starts.append(j)
            cur_base = o[j] // win
        elif c[j] == 0:
            continue
        elif o[j] + c[j] > (cur_base + 2) * win:
            starts.append(j)
            cur_base = o[j] // win
    ns = len(starts)
    if ns_pad is None:
        ns_pad = max(_round_up(ns, 8), 8)
    if ns > ns_pad:
        raise ValueError(f"{ns} segments > ns_pad {ns_pad}")
    seg_ptr = np.full(ns_pad + 1, nb, np.int32)
    seg_ptr[:ns] = starts
    return seg_ptr


def decode_edges(tiles: EdgeTiles):
    """Global ``(rows, cols, w)`` of every packed edge, as tensors on
    the tiles' device (``w`` = per-edge values, ones when there are
    none). Sentinel and pad entries contribute nothing."""
    blk_rc = tiles.blk_rc.long()
    nb = blk_rc.shape[0]
    off = tiles.off.long()
    start, cnt = off[0, :nb], off[1, :nb]
    ent = torch.repeat_interleave(
        torch.arange(nb, device=blk_rc.device), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    eidx = start[ent] + (torch.arange(ent.shape[0], device=blk_rc.device)
                         - first[ent])
    code = tiles.coords.reshape(-1)[eidx].long() & 0xFFFF
    shift = tiles.bk.bit_length() - 1
    lr = code >> shift
    lc = code & (tiles.bk - 1)
    rows = (blk_rc[ent] >> 16) * tiles.bm + lr
    cols = (blk_rc[ent] & 0xFFFF) * tiles.bk + lc
    if tiles.vals is not None:
        w = tiles.vals.reshape(-1)[eidx].float()
    else:
        w = torch.ones(eidx.shape[0], dtype=torch.float32,
                       device=blk_rc.device)
    # a local row past the tile is dropped, as the TPU kernel's one-hot
    w = torch.where(lr < tiles.bm, w, torch.zeros_like(w))
    return rows.clamp(max=tiles.nrows - 1), cols, w


def edge_stream_spmm_ref(tiles: EdgeTiles, x: torch.Tensor,
                         rv: torch.Tensor, nf: torch.Tensor,
                         transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`edge_stream_spmm`: decode every
    edge to global (row, col) and aggregate with ``index_add_``."""
    rows, cols, w = decode_edges(tiles)
    in_fac, out_fac = (rv, nf) if transpose else (nf, rv)
    xs = x.float() * in_fac.float()[:, None]
    src, dst = (rows, cols) if transpose else (cols, rows)
    n_out = tiles.ncols if transpose else tiles.nrows
    y = torch.zeros((n_out, x.shape[1]), dtype=torch.float32,
                    device=x.device)
    y.index_add_(0, dst, xs.index_select(0, src) * w[:, None])
    return y * out_fac.float()[:, None]


def _lib():
    lib = cuda_build.load("edge_stream")
    if lib.edge_stream_spmm_f32.argtypes is None:
        p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.edge_stream_spmm_f32.argtypes = [p, p, p, p, p, i, p, p, p, p,
                                             i, n, i, i, i, i, p]
        lib.edge_stream_spmm_seg_f32.argtypes = [p, p, p, p, i, i, p, p, p,
                                                 p, i, n, i, i, i, p]
        lib.edge_stream_blocks.argtypes = [i, n, i]
        for fn in (lib.edge_stream_spmm_f32, lib.edge_stream_spmm_seg_f32,
                   lib.edge_stream_blocks):
            fn.restype = i
    return lib


def launch_blocks(tiles: EdgeTiles, f: int, transpose: bool = False) -> int:
    """Thread blocks one launch of K1 (or, forward, of K6) runs on
    ``tiles`` at width ``f`` (builds the kernel library: card only)."""
    n_out_tiles = (tiles.ncols // tiles.bk if transpose
                   else tiles.nrows // tiles.bm)
    return int(_lib().edge_stream_blocks(n_out_tiles, tiles.coords.numel(),
                                         f))


def _check(name, t, dtype, device, shape=None):
    if t.device != device:
        raise ValueError(f"edge_stream_spmm: {name} on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"edge_stream_spmm: {name} is {t.dtype}, "
                        f"expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"edge_stream_spmm: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"edge_stream_spmm: {name} is not contiguous")


def _operands(tiles: EdgeTiles, x: torch.Tensor, in_fac: torch.Tensor,
              out_fac: torch.Tensor, n_in: int):
    """The kernel's float32 operands ``(x, in_fac, out_fac)``, checked
    with the packed tables against ``x``'s device."""
    dev = x.device
    nb = tiles.blk_rc.shape[0]
    if tiles.bm not in (128, 256) or tiles.bk not in (128, 256):
        raise ValueError(f"edge_stream_spmm: tile dims {tiles.bm}x"
                         f"{tiles.bk} not in {{128, 256}}")
    x = x.float().contiguous()
    in_fac = in_fac.float().contiguous()
    out_fac = out_fac.float().contiguous()
    _check("x", x, torch.float32, dev, (n_in, x.shape[1]))
    _check("in_fac", in_fac, torch.float32, dev, (n_in,))
    _check("out_fac", out_fac, torch.float32, dev)
    _check("coords", tiles.coords, torch.int16, dev)
    _check("blk_rc", tiles.blk_rc, torch.int32, dev, (nb,))
    _check("off", tiles.off, torch.int32, dev, (2, nb + 1))
    return x, in_fac, out_fac


def edge_stream_spmm(tiles: EdgeTiles, x: torch.Tensor, rv: torch.Tensor,
                     nf: torch.Tensor, transpose: bool = False
                     ) -> torch.Tensor:
    """``y = A @ x`` (or ``A^T @ x``) with ``A[r, c] = rv[r] * nf[c]``
    (times the per-edge value when ``tiles.vals`` is set) on the packed
    edges and 0 elsewhere. Output float32.

    CUDA tensors launch the hand-written kernel, which applies the
    rank-1 factors itself (``in_fac`` per gathered row, ``out_fac`` per
    written row); CPU tensors take the plain version."""
    assert rv.shape == (tiles.nrows,), rv.shape
    assert nf.shape == (tiles.ncols,), nf.shape
    if x.device.type == "cpu":
        return edge_stream_spmm_ref(tiles, x, rv, nf, transpose)
    if x.device.type != "cuda":
        raise ValueError(f"edge_stream_spmm: unsupported device {x.device}")
    dev = x.device
    nb = tiles.blk_rc.shape[0]
    n_in = tiles.nrows if transpose else tiles.ncols
    n_out = tiles.ncols if transpose else tiles.nrows
    b_out = tiles.bk if transpose else tiles.bm
    in_fac, out_fac = (rv, nf) if transpose else (nf, rv)
    x, in_fac, out_fac = _operands(tiles, x, in_fac, out_fac, n_in)
    _check("t_order", tiles.t_order, torch.int32, dev, (nb,))
    vals = None
    if tiles.vals is not None:
        vals = tiles.vals.float().contiguous()
        _check("vals", vals, torch.float32, dev, tuple(tiles.coords.shape))
    f = x.shape[1]
    y = torch.empty((n_out, f), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().edge_stream_spmm_f32(
        tiles.coords.data_ptr(), None if vals is None else vals.data_ptr(),
        tiles.blk_rc.data_ptr(), tiles.off.data_ptr(),
        tiles.t_order.data_ptr(), nb, x.data_ptr(), in_fac.data_ptr(),
        out_fac.data_ptr(), y.data_ptr(), n_out // b_out,
        tiles.coords.numel(), f, tiles.bm, tiles.bk, int(transpose), stream)
    if err != 0:
        raise RuntimeError(f"edge_stream_spmm: CUDA launch failed "
                           f"(cudaError {err})")
    cuda_build.count_launch(launches, captured,
                            "transpose" if transpose else "forward")
    return y


def edge_stream_spmm_seg_ref(tiles: EdgeTiles, seg_ptr: torch.Tensor,
                             x: torch.Tensor, rv: torch.Tensor,
                             nf: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`edge_stream_spmm_seg`: decode the
    edges of every entry a segment covers and aggregate them with
    ``index_add_``. Rows that no covered edge reaches read 0."""
    nb = tiles.blk_rc.shape[0]
    ptr = seg_ptr.long().clamp(0, nb)
    lo, hi = ptr[:-1], ptr[1:]
    live = lo < hi
    # +1 at each segment's first entry, -1 past its last: entries with
    # a positive running sum are covered
    edge = torch.zeros(nb + 1, dtype=torch.long, device=ptr.device)
    edge.index_add_(0, lo[live], torch.ones_like(lo[live]))
    edge.index_add_(0, hi[live], -torch.ones_like(hi[live]))
    covered = torch.cumsum(edge, 0)[:nb] > 0
    off = tiles.off.clone()
    off[1, :nb] = torch.where(covered, off[1, :nb], torch.zeros_like(
        off[1, :nb]))
    return edge_stream_spmm_ref(dataclasses.replace(tiles, off=off), x, rv,
                                nf)


def edge_stream_spmm_seg(tiles: EdgeTiles, seg_ptr: torch.Tensor,
                         x: torch.Tensor, rv: torch.Tensor,
                         nf: torch.Tensor, f_tile: int = 0) -> torch.Tensor:
    """K6: ``y = rv * (A01 @ (nf * x))`` over the segments of
    ``seg_ptr`` (from :func:`segment_tiles`: non-decreasing, each segment
    inside one row tile). Output float32 ``[nrows, F]``. For the
    transpose, pack the edges with rows and cols swapped, take that
    pack's ``segment_tiles`` and call with ``(nf, rv)``.

    Rank-1 values only: raises on ``tiles.vals``. ``f_tile`` is the TPU
    kernel's feature-tiling hint, kept for signature parity; it does not
    change the result. CUDA tensors launch the hand-written kernel; CPU
    tensors take the plain version."""
    if tiles.vals is not None:
        raise ValueError("edge_stream_spmm_seg is rank-1 only; per-edge "
                         "values take edge_stream_spmm")
    assert rv.shape == (tiles.nrows,), rv.shape
    assert nf.shape == (tiles.ncols,), nf.shape
    if x.device.type == "cpu":
        return edge_stream_spmm_seg_ref(tiles, seg_ptr, x, rv, nf)
    if x.device.type != "cuda":
        raise ValueError(f"edge_stream_spmm_seg: unsupported device "
                         f"{x.device}")
    dev = x.device
    nb = tiles.blk_rc.shape[0]
    x, nf, rv = _operands(tiles, x, nf, rv, tiles.ncols)
    _check("seg_ptr", seg_ptr, torch.int32, dev)
    if seg_ptr.dim() != 1 or seg_ptr.shape[0] < 1:
        raise ValueError(f"edge_stream_spmm_seg: seg_ptr has shape "
                         f"{tuple(seg_ptr.shape)}")
    ns = seg_ptr.shape[0] - 1
    f = x.shape[1]
    y = torch.empty((tiles.nrows, f), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().edge_stream_spmm_seg_f32(
        tiles.coords.data_ptr(), tiles.blk_rc.data_ptr(),
        tiles.off.data_ptr(), seg_ptr.data_ptr(), nb, ns, x.data_ptr(),
        nf.data_ptr(), rv.data_ptr(), y.data_ptr(), tiles.nrows // tiles.bm,
        tiles.coords.numel(), f, tiles.bm, tiles.bk, stream)
    if err != 0:
        raise RuntimeError(f"edge_stream_spmm_seg: CUDA launch failed "
                           f"(cudaError {err})")
    cuda_build.count_launch(launches, captured, "seg")
    return y
