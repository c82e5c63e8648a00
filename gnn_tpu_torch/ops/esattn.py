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
local row past the tile is dropped.

The additive score source (GAT of arXiv:1710.10903, ``gatv1``) walks the
same tiles: per-row ``el [R, H]``, per-column ``er [C, H]`` and
``s = lrelu(el[r, h] + er[c, h])`` at a slope, with ``v`` the columns'
features and each row's self edge ``(r, self_pos[r])`` left out (the
model adds it as a term of its own):

    add_rowmax:  m[r, h] = max s = lrelu(el[r, h] + max er[c, h])
                 (LeakyReLU is monotone; gathers er alone)
    add_terms:   den and num as above, with this s
    backward:    du = ds * (u > 0 ? 1 : slope) with ds as above;
                 d el[r] += du (add_bwd_q, rt-major), d er[c] += du and
                 dv[c] += e gnum[r] (add_bwd_kv, ``t_order``).

One family of entry points serves both sources, keyed by the source's
operands as the CUDA walk is keyed by its score source: ``(q, k)`` with
``n_heads``, or ``(el, er, self_pos)`` with a ``slope``.
:func:`cold_rowmax` (K3), :func:`cold_terms` (K4, an
``autograd.Function`` whose backward runs bwd_q and bwd_kv) and
:func:`cold_backward` (one backward pass alone) launch the hand-written
kernels of ``gnn_tpu_torch/csrc/edge_attention.cu`` on CUDA tensors (one
launch a call, widths up to ``CUDA_MAX_WIDTH``; the additive source's
kernel, ``edge_attention_additive_kernel``, has a name of its own in a
trace and counts under the ``add_`` keys), and on CPU tensors take the
plain versions (``cold_attention_*_ref``, ``cold_additive_*_ref``).
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

# kernel launches ("rowmax", "terms", "bwd_q", "bwd_kv" and the additive
# source's "add_rowmax", "add_terms", "add_bwd_q", "add_bwd_kv");
# incremented only
# where a CUDA kernel is launched. A launch recorded into a CUDA graph
# under capture counts in ``captured`` instead: it runs at each replay of
# the graph (`gnn_tpu_torch.train.dispatch` multiplies)
launches: collections.Counter = collections.Counter()
captured: collections.Counter = collections.Counter()


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
    return a.reshape(a.shape[0], H, a.shape[1] // H)


def _scores(q, k, rows, cols, H):
    """``s[e, h] = q[rows[e], h]·k[cols[e], h]`` ([E, H] float32)."""
    return (_heads(q.float().index_select(0, rows), H)
            * _heads(k.float().index_select(0, cols), H)).sum(-1)


def cold_attention_rowmax_ref(coords, blk_rc, off, q, k, *, n_heads: int,
                              bm: int, bk: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`cold_rowmax` (the dot product)."""
    rows, cols = live_edges(coords, blk_rc, off, bm, bk)
    s = _scores(q, k, rows, cols, n_heads)
    m = torch.full((q.shape[0], n_heads), NEG_SENTINEL, dtype=torch.float32,
                   device=q.device)
    return m.scatter_reduce(0, rows[:, None].expand(-1, n_heads), s, "amax")


def cold_attention_terms_ref(coords, blk_rc, off, t_order, q, k, v,
                             row_max, *, n_heads: int, bm: int, bk: int):
    """Plain PyTorch version of the forward of :func:`cold_terms` (the
    dot product): ``(den [R, H], num [R, n_out])``."""
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


def live_additive_edges(coords, blk_rc, off, self_pos, bm: int, bk: int):
    """:func:`live_edges` without each row's self edge ``(r,
    self_pos[r])``, which the additive source adds as a term of its
    own."""
    rows, cols = live_edges(coords, blk_rc, off, bm, bk)
    keep = self_pos.long().index_select(0, rows) != cols
    return rows[keep], cols[keep]


def _additive_edge_terms(coords, blk_rc, off, el, er, self_pos, slope,
                         bm, bk):
    """Per-edge ``(rows, cols, u, s)``: ``u = el[r] + er[c]`` and ``s =
    lrelu(u)`` ([E, H] float32)."""
    rows, cols = live_additive_edges(coords, blk_rc, off, self_pos, bm, bk)
    u = (el.float().index_select(0, rows)
         + er.float().index_select(0, cols))
    return rows, cols, u, torch.nn.functional.leaky_relu(u, slope)


def cold_additive_rowmax_ref(coords, blk_rc, off, el, er, self_pos, *,
                             slope: float, bm: int, bk: int
                             ) -> torch.Tensor:
    """Plain PyTorch version of :func:`cold_rowmax` (additive)."""
    rows, _, _, s = _additive_edge_terms(coords, blk_rc, off, el, er,
                                         self_pos, slope, bm, bk)
    H = el.shape[1]
    m = torch.full((el.shape[0], H), NEG_SENTINEL, dtype=torch.float32,
                   device=el.device)
    return m.scatter_reduce(0, rows[:, None].expand(-1, H), s, "amax")


def cold_additive_terms_ref(coords, blk_rc, off, t_order, el, er, self_pos,
                            v, row_max, *, slope: float, bm: int, bk: int):
    """Plain PyTorch version of the forward of :func:`cold_terms`
    (additive): ``(den [R, H], num [R, n_out])``."""
    rows, cols, _, s = _additive_edge_terms(coords, blk_rc, off, el, er,
                                            self_pos, slope, bm, bk)
    H = el.shape[1]
    e = torch.exp(s - row_max.float().index_select(0, rows))
    nrows, n_out = el.shape[0], v.shape[1]
    den = torch.zeros((nrows, H), dtype=torch.float32, device=el.device)
    den.index_add_(0, rows, e)
    num = torch.zeros((nrows, n_out), dtype=torch.float32, device=el.device)
    num.index_add_(0, rows, (e[:, :, None] * _heads(
        v.float().index_select(0, cols), H)).reshape(-1, n_out))
    return den, num


def _additive_bwd_terms(coords, blk_rc, off, el, er, self_pos, v, row_max,
                        gden, gnum, slope, bm, bk):
    """Per-edge ``(rows, cols, du, e, gnum rows)`` of the additive
    backward; ``ds`` selects 0 where ``e == 0``, as in the dot
    product's."""
    rows, cols, u, s = _additive_edge_terms(coords, blk_rc, off, el, er,
                                            self_pos, slope, bm, bk)
    H = el.shape[1]
    e = torch.exp(s - row_max.float().index_select(0, rows))
    gn_e = _heads(gnum.float().index_select(0, rows), H)
    t = gden.float().index_select(0, rows) + (
        gn_e * _heads(v.float().index_select(0, cols), H)).sum(-1)
    zero = torch.zeros((), device=e.device)
    ds = torch.where(e > 0, e * t, zero)
    du = torch.where(u > 0, ds, ds * slope)
    return rows, cols, du, e, gn_e


def cold_additive_bwd_q_ref(coords, blk_rc, off, t_order, el, er, self_pos,
                            v, row_max, gden, gnum, *, slope: float,
                            bm: int, bk: int) -> torch.Tensor:
    """Plain version of the add_bwd_q kernel: ``d el [R, H]``."""
    rows, _, du, _, _ = _additive_bwd_terms(coords, blk_rc, off, el, er,
                                            self_pos, v, row_max, gden,
                                            gnum, slope, bm, bk)
    d_el = torch.zeros(el.shape, dtype=torch.float32, device=el.device)
    return d_el.index_add_(0, rows, du)


def cold_additive_bwd_kv_ref(coords, blk_rc, off, t_order, el, er,
                             self_pos, v, row_max, gden, gnum, *,
                             slope: float, bm: int, bk: int):
    """Plain version of the add_bwd_kv kernel: ``(d er [C, H], dv [C,
    n_out])``."""
    _, cols, du, e, gn_e = _additive_bwd_terms(
        coords, blk_rc, off, el, er, self_pos, v, row_max, gden, gnum,
        slope, bm, bk)
    n_out = v.shape[1]
    zero = torch.zeros((), device=e.device)
    d_er = torch.zeros(er.shape, dtype=torch.float32, device=er.device)
    d_er.index_add_(0, cols, du)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    dv.index_add_(0, cols, torch.where(
        e[:, :, None] > 0, e[:, :, None] * gn_e, zero).reshape(-1, n_out))
    return d_er, dv


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
    "add_rowmax": ("esattn_add_rowmax_f32", ("el", "er", "self_pos"),
                   (("r", "H"),)),
    "add_terms": ("esattn_add_terms_f32",
                  ("el", "er", "self_pos", "v", "row_max"),
                  (("r", "H"), ("r", "n"))),
    "add_bwd_q": ("esattn_add_bwd_q_f32",
                  ("el", "er", "self_pos", "v", "row_max", "gden", "gnum"),
                  (("r", "H"),)),
    "add_bwd_kv": ("esattn_add_bwd_kv_f32",
                   ("el", "er", "self_pos", "v", "row_max", "gden",
                    "gnum"), (("c", "H"), ("c", "n"))),
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


def _launch(key, coords, blk_rc, off, t_order, H, bm, bk, slope=None,
            **arrays):
    """Check the arguments of one CUDA kernel, allocate its outputs and
    launch it (one launch) on the current stream; returns the outputs.
    Every C function takes ``(coords, blk_rc, off, t_order, nb,
    inputs..., outputs..., nrows, ncols, n_out, H, bm, bk, e_slots,
    stream)``; the additive source's (``slope`` given) take the slope
    before the stream."""
    from gnn_tpu_torch.ops import cuda_build
    name, inputs, out_dims = _KERNELS[key]
    what = f"edge-stream attention {key}"
    dev = coords.device
    nb = blk_rc.shape[0]
    if slope is None:
        nrows, n_out = arrays["q"].shape
        ncols = arrays["k"].shape[0]
    else:
        nrows, ncols = arrays["el"].shape[0], arrays["er"].shape[0]
        # the rowmax reads no feature rows: its width is the head count
        n_out = arrays["v"].shape[1] if "v" in arrays else H
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
              "gden": "rH", "gnum": "rn", "el": "rH", "er": "cH",
              "self_pos": "r"}
    ins = []
    for a in inputs:
        dtype = torch.int32 if a == "self_pos" else torch.float32
        t = arrays[a].to(dtype).contiguous()
        _check(what, a, t, dtype, dev, tuple(dims[d] for d in shapes[a]))
        ins.append(t)
    outs = [torch.empty((dims[r], dims[c]), dtype=torch.float32, device=dev)
            for r, c in out_dims]
    fn = getattr(cuda_build.load("edge_attention"), name)
    extra = () if slope is None else (float(slope),)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 4 + [i] + [p] * (len(ins) + len(outs))
                       + [i] * 6 + [ctypes.c_long]
                       + [ctypes.c_float] * len(extra) + [p])
        fn.restype = i
    err = fn(coords.data_ptr(), blk_rc.data_ptr(), off.data_ptr(),
             None if t_order is None else t_order.data_ptr(), nb,
             *(t.data_ptr() for t in ins + outs),
             nrows, ncols, n_out, H, bm, bk, coords.numel(), *extra,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")
    cuda_build.count_launch(launches, captured, key)
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

# per score source (the additive one has a slope): its operands' names, in
# the order callers pass them, and the prefix of its launch keys
_SOURCES = {False: (("q", "k"), ""), True: (("el", "er", "self_pos"), "add_")}
# the plain version of each launch key
_PLAIN = {"rowmax": cold_attention_rowmax_ref,
          "terms": cold_attention_terms_ref,
          "bwd_q": cold_attention_bwd_q_ref,
          "bwd_kv": cold_attention_bwd_kv_ref,
          "add_rowmax": cold_additive_rowmax_ref,
          "add_terms": cold_additive_terms_ref,
          "add_bwd_q": cold_additive_bwd_q_ref,
          "add_bwd_kv": cold_additive_bwd_kv_ref}


def _walk(coords, blk_rc, off, t_order, ops, n_heads, bm, bk, slope,
          v=None, row_max=None):
    """Check an entry point's arguments (``v`` and ``row_max``: where the
    mode takes them) and pack its walk ``(coords, blk_rc, off, t_order,
    H, bm, bk, slope)``. The additive source's operands are per head, so
    its head count may be left out."""
    assert slope is not None or n_heads is not None, "n_heads or slope"
    row, col = ops[0], ops[1]
    H = row.shape[1] if n_heads is None else n_heads
    assert H <= HP, H
    assert row.shape[1] == col.shape[1] and row.shape[1] % H == 0, (
        row.shape, col.shape, H)
    if slope is not None:
        assert row.shape[1] == H, (row.shape, H)
        assert ops[2].shape == (row.shape[0],), (ops[2].shape, row.shape)
    if v is not None:
        assert v.shape[0] == col.shape[0] and v.shape[1] % H == 0, (
            v.shape, col.shape)
        assert slope is not None or v.shape == col.shape, (v.shape,
                                                           col.shape)
        assert row_max.shape == (row.shape[0], H), (row_max.shape,
                                                    row.shape, H)
    assert (bm & (bm - 1)) == 0 and (bk & (bk - 1)) == 0, (bm, bk)
    return coords, blk_rc, off, t_order, H, bm, bk, slope


def _pass(mode, walk, ops, *rest):
    """One mode of the walk (``rowmax``, ``terms``, ``bwd_q``, ``bwd_kv``)
    over the score source's operands ``ops`` and the mode's ``rest``
    (``v, row_max[, gden, gnum]``): the CUDA kernel of the source's launch
    key on CUDA tensors (one launch), its plain version on CPU ones."""
    coords, blk_rc, off, t_order, H, bm, bk, slope = walk
    names, prefix = _SOURCES[slope is not None]
    key = prefix + mode
    if _on_cuda(f"edge-stream attention {key}", ops[0]):
        outs = _launch(key, coords, blk_rc, off,
                       t_order if mode == "bwd_kv" else None, H, bm, bk,
                       slope=slope, **dict(zip(
                           names + ("v", "row_max", "gden", "gnum"),
                           (*ops, *rest))))
        return outs[0] if len(outs) == 1 else tuple(outs)
    tiles = (coords, blk_rc, off) + (() if mode == "rowmax" else (t_order,))
    kw = dict(n_heads=H) if slope is None else dict(slope=slope)
    return _PLAIN[key](*tiles, *ops, *rest, bm=bm, bk=bk, **kw)


def cold_rowmax(coords, blk_rc, off, ops, *, bm: int, bk: int,
                n_heads: int | None = None,
                slope: float | None = None) -> torch.Tensor:
    """Per-row max of the cold edge scores over each row's cold edges (but
    its self edge, under the additive source): ``[R, H]`` float32,
    NEG_SENTINEL for rows without one. ``ops`` are the score source's
    operands: ``(q, k)`` with the softmax scale folded into ``q`` and
    ``n_heads``, or ``(el, er, self_pos)`` with the additive source's
    ``slope``. Not differentiable (callers detach the operands). CUDA
    tensors launch K3 (``rowmax`` / ``add_rowmax``); CPU tensors take the
    plain version."""
    return _pass("rowmax", _walk(coords, blk_rc, off, None, ops, n_heads,
                                 bm, bk, slope), ops)


class _Terms(torch.autograd.Function):
    """K4 of either score source: the softmax terms forward, the bwd_q
    and bwd_kv passes backward; no gradient to ``row_max``, the tiles or
    ``self_pos``."""

    @staticmethod
    def forward(ctx, walk, v, row_max, *ops):
        ctx.walk = walk
        ctx.save_for_backward(v, row_max, *ops)
        return _pass("terms", walk, ops, v, row_max)

    @staticmethod
    def backward(ctx, gden, gnum):
        v, row_max, *ops = ctx.saved_tensors
        rest = (v, row_max, gden, gnum)
        d_row = d_col = dv = None
        if ctx.needs_input_grad[3]:
            d_row = _pass("bwd_q", ctx.walk, ops, *rest).to(ops[0].dtype)
        if ctx.needs_input_grad[4] or ctx.needs_input_grad[1]:
            d_col, dv = _pass("bwd_kv", ctx.walk, ops, *rest)
            d_col, dv = d_col.to(ops[1].dtype), dv.to(v.dtype)
        return (None, dv, None, d_row, d_col) + (None,) * (len(ops) - 2)


def cold_terms(coords, blk_rc, off, t_order, ops, v, row_max, *, bm: int,
               bk: int, n_heads: int | None = None,
               slope: float | None = None):
    """Softmax terms of the cold residual: ``den[r, h] = sum_c exp(s_rc,h
    - row_max[r, h])`` and ``num[r, :] = sum_c exp(...) * v_c`` over the
    packed cold edges (but each row's self edge, under the additive
    source), for the score source's ``ops`` (:func:`cold_rowmax`).
    ``row_max`` ``[R, H]`` is the global (hot + cold) row max, finite
    everywhere, and gets no gradient. Differentiable in ``v`` and the
    first two operands: the backward recomputes the scores in two passes
    (:func:`cold_backward`). Returns ``(den [R, H], num [R, n_out])``
    float32. CUDA tensors launch the K4 kernels; CPU tensors take the
    plain versions."""
    walk = _walk(coords, blk_rc, off, t_order, ops, n_heads, bm, bk, slope,
                 v, row_max)
    return _Terms.apply(walk, v, row_max.detach().float(), *ops)


def cold_backward(mode, coords, blk_rc, off, t_order, ops, v, row_max,
                  gden, gnum, *, bm: int, bk: int,
                  n_heads: int | None = None, slope: float | None = None):
    """One backward pass of :func:`cold_terms` for the cotangents
    ``gden``, ``gnum``, as its backward runs it: ``"bwd_q"`` (rt-major)
    gives the first operand's gradient (``dq [R, n_out]`` or ``d el [R,
    H]``), ``"bwd_kv"`` (``t_order``) the second's and ``v``'s (``(dk,
    dv)`` or ``(d er, dv)``), float32. CUDA tensors launch the kernel;
    CPU tensors take the plain version."""
    walk = _walk(coords, blk_rc, off, t_order, ops, n_heads, bm, bk, slope,
                 v, row_max)
    return _pass(mode, walk, ops, v, row_max, gden, gnum)
