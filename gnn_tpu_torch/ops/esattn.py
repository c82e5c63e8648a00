"""Edge-stream attention: the cold residual of GAT's resident hot-block
path, from `gnn_tpu.ops.pallas_esattn`.

Over one packed tile set (the layout of
`gnn_tpu_torch.ops.edgestream.EdgeTiles`: int16 coords, rt-major
entries, the ct-major ``t_order``), with heads as column slices of width
``d = n_out // H`` and the softmax scale folded into ``q``:

    rowmax (K3):  m[r, h]   = max over edges (r, c) of s = q[r, h]·k[c, h]
                  (NEG_SENTINEL for rows without an edge; no gradient)
    terms (K4):   den[r, h] = sum over edges of e = exp(s - row_max[r, h])
                  num[r, :] = sum over edges of e * v[c, :]  (per head)
    backward:     ds = e * (gden[r, h] + gnum[r, h]·v[c, h]), selected
                  to 0 where e == 0; dq[r] += ds k[c] (bwd_q, rt-major),
                  dk[c] += ds q[r] and dv[c] += e gnum[r] (bwd_kv,
                  ``t_order``); ``row_max`` gets no gradient.

An edge counts once per entry however often its coordinate repeats
there (the TPU kernel masks its densified tile with ``A01 > 0``), and a
local row past the tile is dropped. The entry points
:func:`cold_attention_rowmax`, :func:`cold_attention_terms` (an
``autograd.Function``), :func:`cold_attention_bwd_q` and
:func:`cold_attention_bwd_kv` launch the hand-written kernels of
``gnn_tpu_torch/csrc/edge_attention.cu`` on CUDA tensors (one launch a
call, widths up to ``CUDA_MAX_WIDTH``), and on CPU tensors take the
plain versions of the same names with ``_ref``.
"""
from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

NEG_SENTINEL = float(np.finfo(np.float32).min)  # -inf stand-in safe under exp
# the JAX package's head-lane padding bounds the head count
HP = 128
# the CUDA kernels keep [bm, H] row terms in shared memory
CUDA_MAX_HEADS = 32

# kernel launches ("rowmax", "terms", "bwd_q", "bwd_kv"); incremented only
# where a CUDA kernel is launched
launches: collections.Counter = collections.Counter()


def live_edges(coords: torch.Tensor, blk_rc: torch.Tensor,
               off: torch.Tensor, bm: int, bk: int):
    """Global ``(rows, cols)`` (int64) of the edges the attention counts:
    every packed edge of every entry, minus local rows past the tile and
    repeats of a coordinate within one entry. Sentinel and pad entries
    contribute nothing."""
    blk_rc = blk_rc.long()
    nb = blk_rc.shape[0]
    off = off.long()
    start, cnt = off[0, :nb], off[1, :nb]
    dev = blk_rc.device
    ent = torch.repeat_interleave(torch.arange(nb, device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    eidx = start[ent] + (torch.arange(ent.shape[0], device=dev)
                         - first[ent])
    code = coords.reshape(-1)[eidx].long() & 0xFFFF
    shift = bk.bit_length() - 1
    lr = code >> shift
    keep = lr < bm
    # one key per (entry, local row, local col): unique drops the repeats
    key = torch.unique((ent[keep] * bm + lr[keep]) * bk
                       + (code[keep] & (bk - 1)))
    ent, loc = key // (bm * bk), key % (bm * bk)
    rows = (blk_rc[ent] >> 16) * bm + loc // bk
    cols = (blk_rc[ent] & 0xFFFF) * bk + loc % bk
    return rows, cols


def _heads(a: torch.Tensor, H: int) -> torch.Tensor:
    return a.reshape(a.shape[0], H, -1)


def _scores(q, k, rows, cols, H):
    """``s[e, h] = q[rows[e], h]·k[cols[e], h]`` ([E, H] float32)."""
    return (_heads(q.float().index_select(0, rows), H)
            * _heads(k.float().index_select(0, cols), H)).sum(-1)


def _check_dims(q, k, n_heads, bm, bk):
    n_out = q.shape[1]
    assert n_out % n_heads == 0, (n_out, n_heads)
    assert n_heads <= HP, n_heads
    assert k.shape[1] == n_out, (q.shape, k.shape)
    assert (bm & (bm - 1)) == 0 and (bk & (bk - 1)) == 0, (bm, bk)


def cold_attention_rowmax_ref(coords, blk_rc, off, q, k, *, n_heads: int,
                              bm: int, bk: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`cold_attention_rowmax`."""
    rows, cols = live_edges(coords, blk_rc, off, bm, bk)
    s = _scores(q, k, rows, cols, n_heads)
    m = torch.full((q.shape[0], n_heads), NEG_SENTINEL, dtype=torch.float32,
                   device=q.device)
    return m.scatter_reduce(0, rows[:, None].expand(-1, n_heads), s, "amax")


def cold_attention_terms_ref(coords, blk_rc, off, t_order, q, k, v,
                             row_max, *, n_heads: int, bm: int, bk: int):
    """Plain PyTorch version of the forward of
    :func:`cold_attention_terms`: ``(den [R, H], num [R, n_out])``."""
    H = n_heads
    rows, cols = live_edges(coords, blk_rc, off, bm, bk)
    e = torch.exp(_scores(q, k, rows, cols, H)
                  - row_max.float().index_select(0, rows))
    nrows, n_out = q.shape
    den = torch.zeros((nrows, H), dtype=torch.float32, device=q.device)
    den.index_add_(0, rows, e)
    num = torch.zeros((nrows, n_out), dtype=torch.float32, device=q.device)
    num.index_add_(0, rows, (e[:, :, None] * _heads(
        v.float().index_select(0, cols), H)).reshape(-1, n_out))
    return den, num


def _bwd_edge_terms(coords, blk_rc, off, q, k, v, row_max, gden, gnum, H,
                    bm, bk):
    """Per-edge ``(rows, cols, ds, e, gnum rows)`` of the backward. ``ds``
    selects 0 where ``e == 0``, so NaN or inf cotangents of rows whose
    every edge underflows never leak."""
    rows, cols = live_edges(coords, blk_rc, off, bm, bk)
    e = torch.exp(_scores(q, k, rows, cols, H)
                  - row_max.float().index_select(0, rows))
    gn_e = _heads(gnum.float().index_select(0, rows), H)
    t = gden.float().index_select(0, rows) + (
        gn_e * _heads(v.float().index_select(0, cols), H)).sum(-1)
    ds = torch.where(e > 0, e * t, torch.zeros((), device=e.device))
    return rows, cols, ds, e, gn_e


def cold_attention_bwd_q_ref(coords, blk_rc, off, t_order, q, k, v,
                             row_max, gden, gnum, *, n_heads: int, bm: int,
                             bk: int) -> torch.Tensor:
    """Plain version of the bwd_q kernel: ``dq [R, n_out]``."""
    rows, cols, ds, _, _ = _bwd_edge_terms(coords, blk_rc, off, q, k, v,
                                           row_max, gden, gnum, n_heads,
                                           bm, bk)
    n_out = q.shape[1]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dq.index_add_(0, rows, (ds[:, :, None] * _heads(
        k.float().index_select(0, cols), n_heads)).reshape(-1, n_out))
    return dq


def cold_attention_bwd_kv_ref(coords, blk_rc, off, t_order, q, k, v,
                              row_max, gden, gnum, *, n_heads: int, bm: int,
                              bk: int):
    """Plain version of the bwd_kv kernel: ``(dk, dv) [C, n_out]``."""
    rows, cols, ds, e, gn_e = _bwd_edge_terms(
        coords, blk_rc, off, q, k, v, row_max, gden, gnum, n_heads, bm, bk)
    n_out = q.shape[1]
    zero = torch.zeros((), device=e.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dk.index_add_(0, cols, (ds[:, :, None] * _heads(
        q.float().index_select(0, rows), n_heads)).reshape(-1, n_out))
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    dv.index_add_(0, cols, torch.where(
        e[:, :, None] > 0, e[:, :, None] * gn_e, zero).reshape(-1, n_out))
    return dk, dv


# --- the CUDA kernels -------------------------------------------------------

# per kernel (launch-counter key): its C function in edge_attention.cu,
# its inputs in the order the function takes them, and its outputs'
# shapes ("r" = rows, "c" = cols, "n" = n_out)
_KERNELS = {
    "rowmax": ("esattn_rowmax_f32", ("q", "k"), (("r", "H"),)),
    "terms": ("esattn_terms_f32", ("q", "k", "v", "row_max"),
              (("r", "H"), ("r", "n"))),
    "bwd_q": ("esattn_bwd_q_f32",
              ("q", "k", "v", "row_max", "gden", "gnum"), (("r", "n"),)),
    "bwd_kv": ("esattn_bwd_kv_f32",
               ("q", "k", "v", "row_max", "gden", "gnum"),
               (("c", "n"), ("c", "n"))),
}
# the CUDA kernels hold a row across the width in registers: 32 floats a
# lane at most
CUDA_MAX_WIDTH = 1024


def _check(what, name, t, dtype, device, shape=None):
    if t.device != device:
        raise ValueError(f"{what}: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} is not contiguous")


def _launch(key, coords, blk_rc, off, t_order, H, bm, bk, **arrays):
    """Check the arguments of one CUDA kernel, allocate its outputs and
    launch it (one launch) on the current stream; returns the outputs.
    Every C function takes ``(coords, blk_rc, off, t_order, nb,
    inputs..., outputs..., nrows, ncols, n_out, H, bm, bk, e_slots,
    stream)``."""
    from gnn_tpu_torch.ops import cuda_build
    name, inputs, out_dims = _KERNELS[key]
    what = f"edge-stream attention {key}"
    dev = coords.device
    nb = blk_rc.shape[0]
    nrows, n_out = arrays["q"].shape
    ncols = arrays["k"].shape[0]
    if bm not in (128, 256) or bk not in (128, 256):
        raise ValueError(f"{what}: tile dims {bm}x{bk} not in {{128, 256}}")
    if H > CUDA_MAX_HEADS:
        raise ValueError(f"{what}: {H} heads > {CUDA_MAX_HEADS}")
    if n_out > CUDA_MAX_WIDTH:
        raise ValueError(f"{what}: width {n_out} > {CUDA_MAX_WIDTH}")
    if nrows % bm or ncols % bk:
        raise ValueError(f"{what}: {nrows}x{ncols} not a multiple of the "
                         f"{bm}x{bk} tiles")
    _check(what, "coords", coords, torch.int16, dev)
    _check(what, "blk_rc", blk_rc, torch.int32, dev, (nb,))
    _check(what, "off", off, torch.int32, dev, (2, nb + 1))
    if t_order is not None:
        _check(what, "t_order", t_order, torch.int32, dev, (nb,))
    dims = {"r": nrows, "c": ncols, "n": n_out, "H": H}
    shapes = {"q": "rn", "k": "cn", "v": "cn", "row_max": "rH",
              "gden": "rH", "gnum": "rn"}
    ins = []
    for a in inputs:
        t = arrays[a].float().contiguous()
        _check(what, a, t, torch.float32, dev,
               tuple(dims[d] for d in shapes[a]))
        ins.append(t)
    outs = [torch.empty((dims[r], dims[c]), dtype=torch.float32, device=dev)
            for r, c in out_dims]
    fn = getattr(cuda_build.load("edge_attention"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 4 + [i] + [p] * (len(ins) + len(outs))
                       + [i] * 6 + [ctypes.c_long, p])
        fn.restype = i
    err = fn(coords.data_ptr(), blk_rc.data_ptr(), off.data_ptr(),
             None if t_order is None else t_order.data_ptr(), nb,
             *(t.data_ptr() for t in ins + outs),
             nrows, ncols, n_out, H, bm, bk, coords.numel(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")
    launches[key] += 1
    return outs


def launch_blocks(coords, n_out_tiles: int, n_out: int):
    """``(thread blocks, blocks per cluster)`` of one attention launch
    over ``n_out_tiles`` output tiles (row tiles; column tiles for
    bwd_kv) at width ``n_out``; the cluster size follows the packed edge
    slots per tile. Needs the built kernel library (a card)."""
    from gnn_tpu_torch.ops import cuda_build
    fn = cuda_build.load("edge_attention").esattn_blocks
    fn.argtypes = [ctypes.c_int, ctypes.c_long, ctypes.c_int]
    fn.restype = ctypes.c_int
    blocks = int(fn(n_out_tiles, coords.numel(), n_out))
    return blocks, blocks // max(n_out_tiles, 1)


def _on_cuda(what, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return True


# --- public entry points ----------------------------------------------------

def cold_attention_rowmax(coords, blk_rc, off, q, k, *, n_heads: int,
                          bm: int, bk: int) -> torch.Tensor:
    """Per-row max of the cold edge scores ``m[r, h] = max_c q_r·k_c``
    (scale folded into ``q``): ``[R, H]`` float32, NEG_SENTINEL for rows
    without a cold edge. Not differentiable (callers detach the
    operands). CUDA tensors launch the K3 kernel; CPU tensors take the
    plain version."""
    _check_dims(q, k, n_heads, bm, bk)
    if _on_cuda("cold_attention_rowmax", q):
        return _launch("rowmax", coords, blk_rc, off, None, n_heads, bm, bk,
                       q=q, k=k)[0]
    return cold_attention_rowmax_ref(coords, blk_rc, off, q, k,
                                     n_heads=n_heads, bm=bm, bk=bk)


def cold_attention_bwd_q(coords, blk_rc, off, t_order, q, k, v, row_max,
                         gden, gnum, *, n_heads: int, bm: int, bk: int
                         ) -> torch.Tensor:
    """The rt-major backward pass of :func:`cold_attention_terms`:
    ``dq [R, n_out]`` float32 for the cotangents ``gden``, ``gnum``. CUDA
    tensors launch the bwd_q kernel; CPU tensors take the plain
    version."""
    if _on_cuda("cold_attention_bwd_q", q):
        return _launch("bwd_q", coords, blk_rc, off, None, n_heads, bm, bk,
                       q=q, k=k, v=v, row_max=row_max, gden=gden,
                       gnum=gnum)[0]
    return cold_attention_bwd_q_ref(coords, blk_rc, off, t_order, q, k, v,
                                    row_max, gden, gnum, n_heads=n_heads,
                                    bm=bm, bk=bk)


def cold_attention_bwd_kv(coords, blk_rc, off, t_order, q, k, v, row_max,
                          gden, gnum, *, n_heads: int, bm: int, bk: int):
    """The ``t_order`` (col-tile-major) backward pass of
    :func:`cold_attention_terms`: ``(dk, dv) [C, n_out]`` float32. CUDA
    tensors launch the bwd_kv kernel; CPU tensors take the plain
    version."""
    if _on_cuda("cold_attention_bwd_kv", q):
        return tuple(_launch("bwd_kv", coords, blk_rc, off, t_order,
                             n_heads, bm, bk, q=q, k=k, v=v,
                             row_max=row_max, gden=gden, gnum=gnum))
    return cold_attention_bwd_kv_ref(coords, blk_rc, off, t_order, q, k, v,
                                     row_max, gden, gnum, n_heads=n_heads,
                                     bm=bm, bk=bk)


class _Terms(torch.autograd.Function):
    """K4: the softmax terms forward, the bwd_q and bwd_kv passes
    backward; no gradient to ``row_max`` or the tiles."""

    @staticmethod
    def forward(ctx, q, k, v, row_max, tiles):
        coords, blk_rc, off, t_order, H, bm, bk = tiles
        ctx.tiles = tiles
        ctx.save_for_backward(q, k, v, row_max)
        if _on_cuda("cold_attention_terms", q):
            return tuple(_launch("terms", coords, blk_rc, off, None, H, bm,
                                 bk, q=q, k=k, v=v, row_max=row_max))
        return cold_attention_terms_ref(coords, blk_rc, off, t_order, q, k,
                                        v, row_max, n_heads=H, bm=bm, bk=bk)

    @staticmethod
    def backward(ctx, gden, gnum):
        coords, blk_rc, off, t_order, H, bm, bk = ctx.tiles
        args = (coords, blk_rc, off, t_order, *ctx.saved_tensors, gden,
                gnum)
        kw = dict(n_heads=H, bm=bm, bk=bk)
        q, k, v, _ = ctx.saved_tensors
        dq = dk = dv = None
        if ctx.needs_input_grad[0]:
            dq = cold_attention_bwd_q(*args, **kw).to(q.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dk, dv = cold_attention_bwd_kv(*args, **kw)
            dk, dv = dk.to(k.dtype), dv.to(v.dtype)
        return dq, dk, dv, None, None


def cold_attention_terms(coords, blk_rc, off, t_order, q, k, v, row_max, *,
                         n_heads: int, bm: int, bk: int):
    """Softmax terms of the cold residual: ``den[r, h] = sum_c exp(s_rc,h
    - row_max[r, h])`` and ``num[r, :] = sum_c exp(...) * v_c`` over the
    packed cold edges. ``row_max`` ``[R, H]`` is the global (hot + cold)
    row max, finite everywhere, and gets no gradient. Differentiable in
    q, k and v: the backward recomputes the scores in two passes (bwd_q
    rt-major, bwd_kv in ``t_order``). Returns ``(den [R, H], num [R,
    n_out])`` float32. CUDA tensors launch the K4 kernels; CPU tensors
    take the plain versions."""
    _check_dims(q, k, n_heads, bm, bk)
    assert v.shape == k.shape, (v.shape, k.shape)
    assert row_max.shape == (q.shape[0], n_heads), (row_max.shape,
                                                    q.shape, n_heads)
    return _Terms.apply(q, k, v, row_max.detach().float(),
                        (coords, blk_rc, off, t_order, n_heads, bm, bk))
