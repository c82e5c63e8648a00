"""Hot-block attention on its live entries: the hot part of
`gnn_tpu_torch.models.gat.hot_attention` that a score source hands over
on a resident layer of one part. The additive source (GAT of
arXiv:1710.10903, ``gatv1``; `gat.AdditiveScores.hot_part`) hands over a
:class:`LiveGrid`, the dot-product source (``gat``;
`gat.DotScores.hot_part`) a :class:`DotLiveGrid`. The two share the live
set (the mask pass) and nothing of their arithmetic.

The hot part runs over a layer's batch-present compacted grid ``[rh,
ch]`` (rows: present row slots, columns: present column slots). An
entry ``(r, c)`` is live where the resident block holds an edge between
their slots, both are true present positions (the present arrays pad by
repeating slot 0) and ``c`` is not row ``r``'s own column (the model
adds the self edge as a term of its own). With ``el [rh, H]`` of the
rows, ``er [ch, H]`` and ``v [ch, H d]`` of the columns and ``rm [rh,
H]`` the combined row max, per live entry and head:

    u = el[r, h] + er[c, h],  s = lrelu(u),  e = exp(s - rm[r, h])
    rowmax:   m[r, h]   = max s                  (-inf: no live entry)
    terms:    den[r, h] = sum e,   num[r, h, :] = sum e * v[c, h, :]
    bwd_row:  d el[r]   = sum dx,  dx = ds * (u > 0 ? 1 : slope),
              ds = e * (gden[r, h] + gnum[r, h, :]·v[c, h, :]) (0 where
              e == 0)
    bwd_col:  d er[c]   = sum dx,  dv[c, h, :] = sum e * gnum[r, h, :]

With ``q [rh, H d]`` of the rows, ``k``, ``v [ch, H d]`` of the columns
and ``scale = 1 / sqrt(d)``, the dot-product modes per live entry and
head (:func:`dot_rowmax`, :func:`dot_terms` and its backward):

    s = scale * q[r, h, :]·k[c, h, :],  e = exp(s - rm[r, h])
    dot_rowmax:  m[r, h] = max s
    dot_terms:   den[r, h] = sum e,   num[r, h, :] = sum e * v[c, h, :]
    dot_bwd_row: dq[r] = scale * sum ds * k[c],  ds = e * (gden[r, h] +
                 gnum[r, h, :]·v[c, h, :])
    dot_bwd_col: dk[c] = scale * sum ds * q[r],  dv[c] = sum e * gnum[r]

The live set is a bit mask (:func:`live_masks`: int32 words ``[rh,
ceil(ch / 32)]``, bit ``c % 32`` of word ``c // 32``, and its transpose
``[ch, ceil(rh / 32)]`` for the column side), built once a layer and
step; the backward keeps it instead of float32 grids. :func:`rowmax`
(no gradient) and :func:`terms` (an ``autograd.Function`` whose
backward is ``bwd_row`` and ``bwd_col``) launch the hand-written kernels
of ``gnn_tpu_torch/csrc/hot_attention.cu`` on CUDA tensors and take the
plain versions (``*_ref``: the masked dense formulas) on CPU tensors; so
do the dot-product modes. The dot modes' plain versions are the dense
grid's own operations in its order (`gat.DenseGrid`, autograd's for the
backward), so a CPU layer gives the dense route's bits.

Counter: a training forward's row max adds ``H x`` its live entries to
a per-device int64 buffer (:func:`live_counter`), on the device and
inside CUDA-graph replays alike; :func:`record_live_entries`, which
`gat.AttentionCounts.epoch_end` calls at each epoch's end after its one
read of the losses, moves what the buffer gained into the recorder's
counter ``attn.hot_live_entries``.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from gnn_tpu_torch.ops.hotdense import _take_rows_fill
from gnn_tpu_torch.utils.timing import count

_NEG_INF = float("-inf")

# kernel launches by mode ("mask", "rowmax", "terms", "bwd_row",
# "bwd_col"; the dot product's "dot_rowmax", "dot_terms", "dot_bwd_row",
# "dot_bwd_col"); a launch recorded into a CUDA graph under capture counts in
# ``captured`` (`gnn_tpu_torch.train.dispatch` multiplies by the replays)
launches: collections.Counter = collections.Counter()
captured: collections.Counter = collections.Counter()

# per device: the int64 live-entry buffer and what was last recorded of it
_LIVE: dict = {}


# --- the live set ------------------------------------------------------------

def pack_bits(live: torch.Tensor) -> torch.Tensor:
    """``[R, C]`` bool -> ``[R, ceil(C / 32)]`` int32 words (bit ``c %
    32`` of word ``c // 32``)."""
    R, C = live.shape
    W = -(-C // 32)
    padded = torch.zeros((R, W * 32), dtype=torch.int64, device=live.device)
    padded[:, :C] = live.long()
    shifts = torch.arange(32, dtype=torch.int64, device=live.device)
    words = (padded.reshape(R, W, 32) << shifts).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of :func:`pack_bits`: ``[R, n]`` bool."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.long()[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :n].bool()


def live_masks_ref(dense, prs, pcs, cmp_r, cmp_c, own):
    """Plain version of :func:`live_masks`: the live grid as the dense
    path's mask, ``dense[prs][:, pcs] != 0`` on the true present rows and
    columns (those a slot's present index points back to) without each
    row's own column, packed both ways, and its rows' and columns' live
    counts."""
    rh, ch = prs.shape[0], pcs.shape[0]
    dev = prs.device
    row_ok = cmp_r.long().index_select(0, prs.long()) == torch.arange(
        rh, device=dev)
    col_ok = cmp_c.long().index_select(0, pcs.long()) == torch.arange(
        ch, device=dev)
    sub = dense.index_select(0, prs.long()).index_select(1, pcs.long()) != 0
    live = (sub & row_ok[:, None] & col_ok[None, :]
            & (torch.arange(ch, device=dev)[None, :] != own.long()[:, None]))
    return (pack_bits(live), pack_bits(live.t()),
            live.sum(1, dtype=torch.int32), live.sum(0, dtype=torch.int32))


# --- plain versions of the modes ---------------------------------------------

def _grid(bits, elh, erh, rm, slope):
    """``(live [H, rh, ch], u, e)``: the live mask and, over the dense
    grid, ``u = el + er`` and ``e = exp(lrelu(u) - rm)`` (0 off the live
    set)."""
    live = unpack_bits(bits, erh.shape[0])[None]
    u = elh.t()[:, :, None] + erh.t()[:, None, :]
    e = torch.exp(F.leaky_relu(u, slope) - rm.t()[:, :, None])
    return live, u, torch.where(live, e, torch.zeros((), device=e.device))


def _heads(a, H):     # [n, H d] -> [H, n, d]
    return a.reshape(a.shape[0], H, -1).transpose(0, 1)


def _flat(a):         # [H, n, d] -> [n, H d]
    return a.transpose(0, 1).reshape(a.shape[1], -1)


def rowmax_ref(bits, elh, erh, slope: float) -> torch.Tensor:
    """Plain version of :func:`rowmax` (without the count): ``[rh, H]``
    ``lrelu(el + max er)`` over each row's live columns, -inf for a row
    without one (LeakyReLU is monotone, so this is the max score
    exactly)."""
    live = unpack_bits(bits, erh.shape[0])
    mx = torch.where(live[None], erh.t()[:, None, :],
                     torch.full((), _NEG_INF, device=erh.device)).amax(2)
    return F.leaky_relu(elh + mx.t(), slope)


def terms_ref(bits, elh, erh, vh, rm, slope: float):
    """Plain version of the forward of :func:`terms`: ``(den [rh, H],
    num [rh, H d])``."""
    _, _, e = _grid(bits, elh, erh, rm, slope)
    return e.sum(2).t(), _flat(torch.matmul(e, _heads(vh, elh.shape[1])))


def _bwd_grid(bits, elh, erh, vh, rm, gden, gnum, slope):
    """``(dx [H, rh, ch], e)`` of the backward over the dense grid."""
    H = elh.shape[1]
    live, u, e = _grid(bits, elh, erh, rm, slope)
    t = gden.t()[:, :, None] + torch.matmul(_heads(gnum, H),
                                            _heads(vh, H).transpose(1, 2))
    zero = torch.zeros((), device=e.device)
    ds = torch.where(e > 0, e * t, zero)
    return torch.where(u > 0, ds, ds * slope), e


def bwd_row_ref(bits, elh, erh, vh, rm, gden, gnum, slope: float):
    """Plain version of the row pass of :func:`terms`' backward: ``d el
    [rh, H]``."""
    dx, _ = _bwd_grid(bits, elh, erh, vh, rm, gden, gnum, slope)
    return dx.sum(2).t()


def bwd_col_ref(bits_t, elh, erh, vh, rm, gden, gnum, slope: float):
    """Plain version of the column pass of :func:`terms`' backward, from
    the transposed mask: ``(d er [ch, H], dv [ch, H d])``."""
    bits = pack_bits(unpack_bits(bits_t, elh.shape[0]).t())
    dx, e = _bwd_grid(bits, elh, erh, vh, rm, gden, gnum, slope)
    dv = torch.matmul(e.transpose(1, 2), _heads(gnum, elh.shape[1]))
    return dx.sum(1).t(), _flat(dv)


def _dot_scores(bits, qh, kh, H: int, scale: float):
    """``[H, rh, ch]`` scores ``q·k * scale`` over the dense grid, -inf
    off the live set (the dense grid's operations, in its order)."""
    live = unpack_bits(bits, kh.shape[0])[None]
    return torch.where(
        live, torch.matmul(_heads(qh, H), _heads(kh, H).transpose(1, 2))
        * scale, torch.full((), _NEG_INF, device=qh.device))


def dot_rowmax_ref(bits, qh, kh, H: int, scale: float) -> torch.Tensor:
    """Plain version of :func:`dot_rowmax` (without the count): ``[rh,
    H]``, -inf for a row without a live entry."""
    return _dot_scores(bits, qh, kh, H, scale).amax(2).t()


def dot_terms_ref(bits, qh, kh, vh, rm, H: int, scale: float, s=None):
    """Plain version of the forward of :func:`dot_terms`: ``(den [rh, H],
    num [rh, H d])``; ``s``: the scores of :func:`_dot_scores`, if
    already taken."""
    if s is None:
        s = _dot_scores(bits, qh, kh, H, scale)
    e = torch.exp(s - rm.t()[:, :, None])
    return e.sum(dim=2).t(), _flat(torch.matmul(e, _heads(vh, H)))


def _dot_bwd_grid(bits, qh, kh, vh, rm, gden, gnum, H, scale):
    """``(g [H, rh, ch], e)``: the cotangent of the dense grid's product
    ``q·k`` (before the scale) and ``e``, as autograd takes them."""
    s = _dot_scores(bits, qh, kh, H, scale)
    e = torch.exp(s - rm.t()[:, :, None])
    g_e = gden.t()[:, :, None] + torch.matmul(
        _heads(gnum, H), _heads(vh, H).transpose(1, 2))
    live = unpack_bits(bits, kh.shape[0])[None]
    return torch.where(live, g_e * e, 0.0) * scale, e


def dot_bwd_row_ref(bits, qh, kh, vh, rm, gden, gnum, H: int,
                    scale: float):
    """Plain version of the row pass of :func:`dot_terms`' backward:
    ``dq [rh, H d]``."""
    g, _ = _dot_bwd_grid(bits, qh, kh, vh, rm, gden, gnum, H, scale)
    return _flat(torch.matmul(g, _heads(kh, H)))


def dot_bwd_col_ref(bits_t, qh, kh, vh, rm, gden, gnum, H: int,
                    scale: float):
    """Plain version of the column pass of :func:`dot_terms`' backward,
    from the transposed mask: ``(dk [ch, H d], dv [ch, H d])``."""
    bits = pack_bits(unpack_bits(bits_t, qh.shape[0]).t())
    g, e = _dot_bwd_grid(bits, qh, kh, vh, rm, gden, gnum, H, scale)
    dk = torch.matmul(_heads(qh, H).transpose(1, 2), g).transpose(1, 2)
    dv = torch.matmul(e.transpose(1, 2), _heads(gnum, H))
    return _flat(dk), _flat(dv)


# --- the CUDA kernels ----------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# each C function's arguments (csrc/hot_attention.cu): the words, the
# order of the output rows, their count and the other side's, the inputs,
# the outputs, H and d, the slope (the dot modes: the scale), then the
# stream
_SIGS = {
    "hotattn_mask": [_P, _I, _I, _P, _I, _P, _P, _P, _I] + [_P] * 5,
    "hotattn_rowmax": [_P, _P, _I, _I, _P, _P, _P, _I, _F, _P, _P],
    "hotattn_terms": [_P, _P, _I, _I] + [_P] * 6 + [_I, _I, _F, _P],
    "hotattn_bwd_row": [_P, _P, _I, _I] + [_P] * 7 + [_I, _I, _F, _P],
    "hotattn_bwd_col": [_P, _P, _I, _I] + [_P] * 8 + [_I, _I, _F, _P],
    "hotattn_dot_rowmax": [_P, _P, _I, _I, _P, _P, _P, _I, _I, _F, _P, _P],
    "hotattn_dot_terms": [_P, _P, _I, _I] + [_P] * 6 + [_I, _I, _F, _P],
    "hotattn_dot_bwd_row": [_P, _P, _I, _I] + [_P] * 7 + [_I, _I, _F, _P],
    "hotattn_dot_bwd_col": [_P, _P, _I, _I] + [_P] * 8 + [_I, _I, _F, _P],
}
# a lane holds at most 32 floats of a head's width (csrc: MAXF)
_MAXF = 32


def _call(key: str, dev, *args) -> None:
    """Launch ``hotattn_<key>`` on ``dev``'s current stream and count it;
    raises if the launch failed."""
    from gnn_tpu_torch.ops import cuda_build
    name = f"hotattn_{key}"
    fn = getattr(cuda_build.load("hot_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGS[name]
        fn.restype = ctypes.c_int
    err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hot attention {key}: CUDA launch failed "
                           f"(cudaError {err})")
    cuda_build.count_launch(launches, captured, key)


def _f32(key, name, t, shape):
    """``t`` as a contiguous float32 tensor of ``shape`` with a 16 B
    aligned start (the kernels' vector loads)."""
    t = t.detach().float().contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"hot attention {key}: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    return t


def _check_words(key, name, w, rows, n):
    want = (rows, -(-n // 32))
    if w.dtype != torch.int32 or not w.is_contiguous() or \
            tuple(w.shape) != want:
        raise ValueError(f"hot attention {key}: {name} is not int32 "
                         f"{list(want)} contiguous")


def _check_width(key, H, d):
    L = 1
    while 2 * L * H <= 32:
        L *= 2
    if H > 32 or -(-d // L) > _MAXF:
        raise ValueError(f"hot attention {key}: {H} heads of {d} is wider "
                         f"than the kernels hold ({_MAXF} floats a lane, "
                         f"{L} lanes a head)")


def _on_cuda(key, t) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"hot attention {key}: unsupported device "
                         f"{t.device}")
    return True


# --- the live-entry counter ------------------------------------------------------

def live_counter(device) -> torch.Tensor:
    """The int64 ``[1]`` buffer on ``device`` into which training forwards
    count ``H x`` their live hot entries. Made at first use, which must
    not be under CUDA-graph capture (a capture's eager warm-up steps come
    first)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = str(device)
    if key not in _LIVE:
        if device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError("hot attention: the live-entry buffer is "
                               "first needed under CUDA-graph capture")
        _LIVE[key] = [torch.zeros(1, dtype=torch.int64, device=device), 0]
    return _LIVE[key][0]


def record_live_entries() -> None:
    """Add what each device's live-entry buffer gained since the last call
    to the recorder's counter ``attn.hot_live_entries`` (the current
    epoch's). Reads each buffer once (a wait on its device): call it
    where the epoch already waits for the card. Records nothing where no
    buffer was made (no live hot attention ran in this process)."""
    for entry in _LIVE.values():
        total = int(entry[0].item())
        count("attn.hot_live_entries", total - entry[1])
        entry[1] = total


# --- entry points --------------------------------------------------------------

def live_masks(dense, prs, pcs, cmp_r, cmp_c, own):
    """The live set of a layer's present grid as ``(bits [rh, ceil(ch /
    32)], bits_t [ch, ceil(rh / 32)])`` int32 words, with the live
    entries of each row ``[rh]`` and column ``[ch]`` (int32). ``dense`` is the
    resident block ``[k, k]`` (bfloat16, float16 or float32), ``prs
    [rh]`` / ``pcs [ch]`` the present row / column slots, ``cmp_r`` /
    ``cmp_c [k]`` each slot's present row / column index (-1: none),
    ``own [rh]`` each present row's own column (a value outside ``[0,
    ch)``: none). CUDA tensors launch the mask pass (one call: a row
    kernel, then a bit transpose); CPU tensors take
    :func:`live_masks_ref`."""
    if not _on_cuda("mask", dense):
        return live_masks_ref(dense, prs, pcs, cmp_r, cmp_c, own)
    k = dense.shape[0]
    rh, ch = prs.shape[0], pcs.shape[0]
    es = dense.element_size()
    if tuple(dense.shape) != (k, k) or not dense.is_contiguous() or \
            es not in (2, 4) or (k * es) % 16 or dense.data_ptr() % 16:
        raise ValueError(f"hot attention mask: the block must be a "
                         f"contiguous, 16 B aligned [k, k] of 2 or 4 B "
                         f"entries, k * {es} a multiple of 16 (got "
                         f"{tuple(dense.shape)} {dense.dtype})")
    # the row kernel keeps a row's words in shared memory, 8 rows a block
    if 8 * 4 * -(-ch // 32) > 48 * 1024:
        raise ValueError(f"hot attention mask: {ch} present columns are "
                         f"more than the row kernel's shared memory holds")
    prs_, cmp_r_, cmp_c_, own_ = (t.to(torch.int32).contiguous()
                                  for t in (prs, cmp_r, cmp_c, own))
    bits = torch.empty((rh, -(-ch // 32)), dtype=torch.int32,
                       device=dense.device)
    bits_t = torch.empty((ch, -(-rh // 32)), dtype=torch.int32,
                         device=dense.device)
    n_r = torch.empty(rh, dtype=torch.int32, device=dense.device)
    n_c = torch.empty(ch, dtype=torch.int32, device=dense.device)
    _call("mask", dense.device, dense.data_ptr(), es, k, prs_.data_ptr(),
          rh, cmp_r_.data_ptr(), cmp_c_.data_ptr(), own_.data_ptr(), ch,
          bits.data_ptr(), bits_t.data_ptr(), n_r.data_ptr(), n_c.data_ptr())
    return bits, bits_t, n_r, n_c


def _order(key, order, n):
    """The data pointer of ``order`` (int32 ``[n]``: the order in which
    the kernel's blocks take the output rows), or None."""
    if order is None:
        return None
    if order.dtype != torch.int32 or tuple(order.shape) != (n,) or \
            not order.is_contiguous():
        raise ValueError(f"hot attention {key}: order is not int32 [{n}] "
                         f"contiguous")
    return order.data_ptr()


def rowmax(bits, elh, erh, slope: float, count_live: bool = False,
           order=None):
    """Per-row max of the live hot scores, ``[rh, H]`` float32, -inf for
    a row without a live entry; no gradient. ``count_live``: add ``H x``
    the live entries to :func:`live_counter`. ``order``: the order in
    which the kernel's blocks take the rows (a permutation of ``rh``,
    heaviest first; the result does not depend on it). CUDA tensors
    launch the rowmax kernel; CPU tensors take :func:`rowmax_ref`."""
    elh, erh = elh.detach(), erh.detach()
    rh, H = elh.shape
    ch = erh.shape[0]
    if not _on_cuda("rowmax", elh):
        if count_live:
            live_counter(elh.device).add_(unpack_bits(bits, ch).sum() * H)
        return rowmax_ref(bits, elh, erh, slope)
    _check_words("rowmax", "bits", bits, rh, ch)
    _check_width("rowmax", H, 1)
    el_ = _f32("rowmax", "el", elh, (rh, H))
    er_ = _f32("rowmax", "er", erh, (ch, H))
    m = torch.empty((rh, H), dtype=torch.float32, device=elh.device)
    ctr = live_counter(elh.device).data_ptr() if count_live else None
    _call("rowmax", elh.device, bits.data_ptr(), _order("rowmax", order, rh),
          rh, ch, el_.data_ptr(), er_.data_ptr(), m.data_ptr(), H,
          float(slope), ctr)
    return m


def _kernel_operands(key, bits, elh, erh, vh, rm, gden=None, gnum=None):
    """The float32 operands of a terms / backward launch, checked."""
    rh, H = elh.shape
    ch, n = vh.shape
    if n % H:
        raise ValueError(f"hot attention {key}: width {n} over {H} heads")
    _check_width(key, H, n // H)
    ops = [_f32(key, "el", elh, (rh, H)), _f32(key, "er", erh, (ch, H)),
           _f32(key, "v", vh, (ch, n)), _f32(key, "rm", rm, (rh, H))]
    if gden is not None:
        ops += [_f32(key, "gden", gden, (rh, H)),
                _f32(key, "gnum", gnum, (rh, n))]
    return rh, ch, H, n // H, ops


def bwd_row(bits, elh, erh, vh, rm, gden, gnum, slope: float, order=None):
    """The row pass of :func:`terms`' backward: ``d el [rh, H]`` float32
    for the cotangents ``gden [rh, H]``, ``gnum [rh, H d]`` (``order``:
    as :func:`rowmax`'s). CUDA tensors launch the bwd_row kernel; CPU
    tensors take :func:`bwd_row_ref`."""
    if not _on_cuda("bwd_row", elh):
        return bwd_row_ref(bits, elh, erh, vh, rm, gden, gnum, slope)
    rh, ch, H, d, ops = _kernel_operands("bwd_row", bits, elh, erh, vh, rm,
                                         gden, gnum)
    _check_words("bwd_row", "bits", bits, rh, ch)
    d_el = torch.empty((rh, H), dtype=torch.float32, device=elh.device)
    _call("bwd_row", elh.device, bits.data_ptr(),
          _order("bwd_row", order, rh), rh, ch,
          *(t.data_ptr() for t in ops), d_el.data_ptr(), H, d, float(slope))
    return d_el


def bwd_col(bits_t, elh, erh, vh, rm, gden, gnum, slope: float,
            order=None):
    """The column pass of :func:`terms`' backward, over the transposed
    words: ``(d er [ch, H], dv [ch, H d])`` float32 (``order``: of the
    columns, as :func:`rowmax`'s of the rows). CUDA tensors launch the
    bwd_col kernel; CPU tensors take :func:`bwd_col_ref`."""
    if not _on_cuda("bwd_col", elh):
        return bwd_col_ref(bits_t, elh, erh, vh, rm, gden, gnum, slope)
    rh, ch, H, d, ops = _kernel_operands("bwd_col", bits_t, elh, erh, vh,
                                         rm, gden, gnum)
    _check_words("bwd_col", "bits_t", bits_t, ch, rh)
    d_er = torch.empty((ch, H), dtype=torch.float32, device=elh.device)
    dv = torch.empty((ch, H * d), dtype=torch.float32, device=elh.device)
    _call("bwd_col", elh.device, bits_t.data_ptr(),
          _order("bwd_col", order, ch), rh, ch,
          *(t.data_ptr() for t in ops), d_er.data_ptr(), dv.data_ptr(), H,
          d, float(slope))
    return d_er, dv


class _Terms(torch.autograd.Function):
    """The live hot terms forward; backward the row pass (``d el``) and
    the column pass (``d er``, ``dv``). No gradient to ``rm`` or the
    words."""

    @staticmethod
    def forward(ctx, elh, erh, vh, rm, bits, bits_t, slope, orders):
        ctx.save_for_backward(elh, erh, vh, rm, bits, bits_t)
        ctx.slope, ctx.orders = slope, orders
        if not _on_cuda("terms", elh):
            return terms_ref(bits, elh, erh, vh, rm, slope)
        rh, ch, H, d, ops = _kernel_operands("terms", bits, elh, erh, vh,
                                             rm)
        _check_words("terms", "bits", bits, rh, ch)
        den = torch.empty((rh, H), dtype=torch.float32, device=elh.device)
        num = torch.empty((rh, H * d), dtype=torch.float32,
                          device=elh.device)
        _call("terms", elh.device, bits.data_ptr(),
              _order("terms", orders[0], rh), rh, ch,
              *(t.data_ptr() for t in ops), den.data_ptr(), num.data_ptr(),
              H, d, float(slope))
        return den, num

    @staticmethod
    def backward(ctx, gden, gnum):
        elh, erh, vh, rm, bits, bits_t = ctx.saved_tensors
        args = (elh, erh, vh, rm, gden, gnum, ctx.slope)
        d_el = d_er = dv = None
        if ctx.needs_input_grad[0]:
            d_el = bwd_row(bits, *args, order=ctx.orders[0]).to(elh.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            d_er, dv = bwd_col(bits_t, *args, order=ctx.orders[1])
            d_er, dv = d_er.to(erh.dtype), dv.to(vh.dtype)
        return d_el, d_er, dv, None, None, None, None, None


def terms(bits, bits_t, elh, erh, vh, rm, slope: float, orders=(None, None)):
    """Softmax terms of the live hot entries: ``den [rh, H] = sum_c exp(s
    - rm)`` and ``num [rh, H d] = sum_c exp(s - rm) v[c]`` per head, ``s
    = lrelu(el[r] + er[c])``. ``rm [rh, H]`` is the combined row max,
    finite, and gets no gradient. Differentiable in ``el``, ``er`` and
    ``v`` (backward: :func:`bwd_row`, :func:`bwd_col`). ``orders``: the
    rows' and the columns' block order (:func:`rowmax`). CUDA tensors
    launch the terms kernel; CPU tensors take :func:`terms_ref`."""
    return _Terms.apply(elh, erh, vh, rm.detach().float(), bits, bits_t,
                        float(slope), orders)


@dataclasses.dataclass
class LiveGrid:
    """One unsharded layer's hot part on its live entries: the words of
    the live set, the rows and columns in order of their live entries
    (most first: the kernels' block order), and the present rows' and
    columns' operands (``el``, ``er``, ``v`` gathered,
    differentiable)."""

    bits: torch.Tensor
    bits_t: torch.Tensor
    orders: tuple         # (int32 [rh], int32 [ch])
    elh: torch.Tensor     # [rh, H]
    erh: torch.Tensor     # [ch, H]
    vh: torch.Tensor      # [ch, H d]
    slope: float

    def rowmax(self, count_live: bool) -> torch.Tensor:
        """``m_hot [H, rh]`` (-inf: no live entry), no gradient."""
        return rowmax(self.bits, self.elh, self.erh, self.slope,
                      count_live, self.orders[0]).t()

    def terms(self, rm_cmp: torch.Tensor):
        """``(den_hot [H, rh], num_hot [H, rh, d])`` for the combined row
        max of the present rows ``rm_cmp [rh, H]``."""
        den, num = terms(self.bits, self.bits_t, self.elh, self.erh,
                         self.vh, rm_cmp, self.slope, self.orders)
        H = self.elh.shape[1]
        return den.t(), num.reshape(num.shape[0], H, -1).transpose(0, 1)


def mask_operands(adj, r_loc, self_pos=None):
    """The arguments of :func:`live_masks` for an unsharded resident layer
    ``adj`` (`gnn_tpu_torch.ops.hotdense.HotDenseAdj`): its block, its
    present slots, each slot's present row and column (-1: none) and each
    present row's own column (``r_loc``: the present rows' local rows;
    ``self_pos [nrows]``: each row's own local column; None: no row has
    one, -1 for every row)."""
    cmp_r = _take_rows_fill(adj.row_cmp_idx[:, None], adj.rowpos,
                            fill=-1)[:, 0]
    cmp_c = _take_rows_fill(adj.col_cmp_idx[:, None], adj.colpos,
                            fill=-1)[:, 0]
    if self_pos is None:
        own_cmp = torch.full((r_loc.shape[0],), -1, dtype=torch.int32,
                             device=r_loc.device)
    else:
        own = _take_rows_fill(self_pos[:, None], r_loc, fill=-1)[:, 0]
        own_cmp = _take_rows_fill(adj.col_cmp_idx[:, None], own,
                                  fill=-1)[:, 0]
    return (adj.dense, adj.present_row_slots, adj.present_col_slots, cmp_r,
            cmp_c, own_cmp)


def _live_set(adj, r_loc, self_pos=None):
    """``(bits, bits_t, orders)`` of an unsharded resident layer: its live
    set (:func:`mask_operands`, :func:`live_masks`) and its rows and
    columns in order of their live entries, most first."""
    bits, bits_t, n_r, n_c = live_masks(*mask_operands(adj, r_loc,
                                                       self_pos))
    orders = tuple(torch.argsort(n, descending=True, stable=True).to(
        torch.int32) for n in (n_r, n_c))
    return bits, bits_t, orders


def live_grid(adj, r_loc, c_loc, el, er, v, self_pos, slope: float
              ) -> LiveGrid:
    """The :class:`LiveGrid` of an unsharded resident layer: its live set
    (:func:`_live_set`) and the present rows' ``el [nrows, H]``, the
    present columns' ``er [ncols, H]`` and ``v [ncols, H d]`` gathered
    (``r_loc`` / ``c_loc``: the present rows' / columns' local
    indices)."""
    bits, bits_t, orders = _live_set(adj, r_loc, self_pos)
    return LiveGrid(bits=bits, bits_t=bits_t, orders=orders,
                    elh=_take_rows_fill(el, r_loc),
                    erh=_take_rows_fill(er, c_loc),
                    vh=_take_rows_fill(v, c_loc), slope=slope)


# --- the dot-product source's entry points ---------------------------------------

def _count_live_ref(bits, n: int, H: int) -> None:
    """A CPU row max's count: ``H x`` the live entries of ``bits`` into
    :func:`live_counter`."""
    live_counter(bits.device).add_(unpack_bits(bits, n).sum() * H)


def _dot_operands(key, bits, qh, kh, vh, H, rm=None, gden=None, gnum=None):
    """The float32 operands of a dot launch, checked: ``rh, ch, d`` and
    ``[q, k, (v, rm, (gden, gnum))]``."""
    rh, n = qh.shape
    ch = kh.shape[0]
    if n % H:
        raise ValueError(f"hot attention {key}: width {n} over {H} heads")
    d = n // H
    _check_width(key, H, d)
    ops = [_f32(key, "q", qh, (rh, n)), _f32(key, "k", kh, (ch, n))]
    if vh is not None:
        ops += [_f32(key, "v", vh, (ch, n)), _f32(key, "rm", rm, (rh, H))]
    if gden is not None:
        ops += [_f32(key, "gden", gden, (rh, H)),
                _f32(key, "gnum", gnum, (rh, n))]
    return rh, ch, d, ops


def dot_rowmax(bits, qh, kh, H: int, scale: float, count_live: bool = False,
               order=None):
    """Per-row max of the live dot-product scores, ``[rh, H]`` float32,
    -inf for a row without a live entry; no gradient. ``count_live``,
    ``order``: as :func:`rowmax`'s. CUDA tensors launch the dot_rowmax
    kernel; CPU tensors take :func:`dot_rowmax_ref`."""
    qh, kh = qh.detach(), kh.detach()
    if not _on_cuda("dot_rowmax", qh):
        if count_live:
            _count_live_ref(bits, kh.shape[0], H)
        return dot_rowmax_ref(bits, qh, kh, H, scale)
    rh, ch, d, ops = _dot_operands("dot_rowmax", bits, qh, kh, None, H)
    _check_words("dot_rowmax", "bits", bits, rh, ch)
    m = torch.empty((rh, H), dtype=torch.float32, device=qh.device)
    ctr = live_counter(qh.device).data_ptr() if count_live else None
    _call("dot_rowmax", qh.device, bits.data_ptr(),
          _order("dot_rowmax", order, rh), rh, ch,
          *(t.data_ptr() for t in ops), m.data_ptr(), H, d, float(scale),
          ctr)
    return m


def dot_bwd_row(bits, qh, kh, vh, rm, gden, gnum, H: int, scale: float,
                order=None):
    """The row pass of :func:`dot_terms`' backward: ``dq [rh, H d]``
    float32 for the cotangents ``gden [rh, H]``, ``gnum [rh, H d]``. CUDA
    tensors launch the dot_bwd_row kernel; CPU tensors take
    :func:`dot_bwd_row_ref`."""
    if not _on_cuda("dot_bwd_row", qh):
        return dot_bwd_row_ref(bits, qh, kh, vh, rm, gden, gnum, H, scale)
    rh, ch, d, ops = _dot_operands("dot_bwd_row", bits, qh, kh, vh, H, rm,
                                   gden, gnum)
    _check_words("dot_bwd_row", "bits", bits, rh, ch)
    dq = torch.empty((rh, H * d), dtype=torch.float32, device=qh.device)
    _call("dot_bwd_row", qh.device, bits.data_ptr(),
          _order("dot_bwd_row", order, rh), rh, ch,
          *(t.data_ptr() for t in ops), dq.data_ptr(), H, d, float(scale))
    return dq


def dot_bwd_col(bits_t, qh, kh, vh, rm, gden, gnum, H: int, scale: float,
                order=None):
    """The column pass of :func:`dot_terms`' backward, over the
    transposed words: ``(dk [ch, H d], dv [ch, H d])`` float32
    (``order``: of the columns). CUDA tensors launch the dot_bwd_col
    kernel; CPU tensors take :func:`dot_bwd_col_ref`."""
    if not _on_cuda("dot_bwd_col", qh):
        return dot_bwd_col_ref(bits_t, qh, kh, vh, rm, gden, gnum, H, scale)
    rh, ch, d, ops = _dot_operands("dot_bwd_col", bits_t, qh, kh, vh, H, rm,
                                   gden, gnum)
    _check_words("dot_bwd_col", "bits_t", bits_t, ch, rh)
    dk = torch.empty((ch, H * d), dtype=torch.float32, device=qh.device)
    dv = torch.empty((ch, H * d), dtype=torch.float32, device=qh.device)
    _call("dot_bwd_col", qh.device, bits_t.data_ptr(),
          _order("dot_bwd_col", order, ch), rh, ch,
          *(t.data_ptr() for t in ops), dk.data_ptr(), dv.data_ptr(), H, d,
          float(scale))
    return dk, dv


class _DotTerms(torch.autograd.Function):
    """The live dot-product terms forward; backward the row pass (``dq``)
    and the column pass (``dk``, ``dv``). No gradient to ``rm``, the words
    or ``s`` (a CPU row max's dense scores, reused by the plain
    forward)."""

    @staticmethod
    def forward(ctx, qh, kh, vh, rm, bits, bits_t, H, scale, orders, s):
        ctx.save_for_backward(qh, kh, vh, rm, bits, bits_t)
        ctx.H, ctx.scale, ctx.orders = H, scale, orders
        if not _on_cuda("dot_terms", qh):
            return dot_terms_ref(bits, qh, kh, vh, rm, H, scale, s)
        rh, ch, d, ops = _dot_operands("dot_terms", bits, qh, kh, vh, H, rm)
        _check_words("dot_terms", "bits", bits, rh, ch)
        den = torch.empty((rh, H), dtype=torch.float32, device=qh.device)
        num = torch.empty((rh, H * d), dtype=torch.float32,
                          device=qh.device)
        _call("dot_terms", qh.device, bits.data_ptr(),
              _order("dot_terms", orders[0], rh), rh, ch,
              *(t.data_ptr() for t in ops), den.data_ptr(), num.data_ptr(),
              H, d, float(scale))
        return den, num

    @staticmethod
    def backward(ctx, gden, gnum):
        qh, kh, vh, rm, bits, bits_t = ctx.saved_tensors
        args = (qh, kh, vh, rm, gden, gnum, ctx.H, ctx.scale)
        dq = dk = dv = None
        if ctx.needs_input_grad[0]:
            dq = dot_bwd_row(bits, *args, order=ctx.orders[0]).to(qh.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dk, dv = dot_bwd_col(bits_t, *args, order=ctx.orders[1])
            dk, dv = dk.to(kh.dtype), dv.to(vh.dtype)
        return dq, dk, dv, None, None, None, None, None, None, None


def dot_terms(bits, bits_t, qh, kh, vh, rm, H: int, scale: float,
              orders=(None, None), s=None):
    """Softmax terms of the live dot-product entries: ``den [rh, H] =
    sum_c exp(s - rm)`` and ``num [rh, H d] = sum_c exp(s - rm) v[c]`` per
    head, ``s = scale * q[r]·k[c]``. ``rm [rh, H]`` is the combined row
    max, finite, and gets no gradient. Differentiable in ``q``, ``k`` and
    ``v`` (backward: :func:`dot_bwd_row`, :func:`dot_bwd_col`). ``s``
    (CPU): the dense scores, if already taken. CUDA tensors launch the
    dot_terms kernel; CPU tensors take :func:`dot_terms_ref`."""
    return _DotTerms.apply(qh, kh, vh, rm.detach().float(), bits, bits_t,
                           int(H), float(scale), orders, s)


@dataclasses.dataclass
class DotLiveGrid:
    """One unsharded layer's dot-product hot part on its live entries:
    the words of the live set, the rows' and columns' block orders, and
    the present rows' ``q`` and the present columns' ``k``, ``v``
    (gathered, differentiable). On CPU tensors the row max keeps its
    dense scores (``s``) for the terms, so the grid's product runs once a
    forward, as the dense route's did."""

    bits: torch.Tensor
    bits_t: torch.Tensor
    orders: tuple         # (int32 [rh], int32 [ch])
    qh: torch.Tensor      # [rh, H d]
    kh: torch.Tensor      # [ch, H d]
    vh: torch.Tensor      # [ch, H d]
    H: int
    scale: float
    s: torch.Tensor = None

    def rowmax(self, count_live: bool) -> torch.Tensor:
        """``m_hot [H, rh]`` (-inf: no live entry), no gradient."""
        if self.qh.is_cuda:
            return dot_rowmax(self.bits, self.qh, self.kh, self.H,
                              self.scale, count_live, self.orders[0]).t()
        if count_live:
            _count_live_ref(self.bits, self.kh.shape[0], self.H)
        self.s = _dot_scores(self.bits, self.qh.detach(), self.kh.detach(),
                             self.H, self.scale)
        return self.s.amax(dim=2)

    def terms(self, rm_cmp: torch.Tensor):
        """``(den_hot [H, rh], num_hot [H, rh, d])`` for the combined row
        max of the present rows ``rm_cmp [rh, H]``."""
        den, num = dot_terms(self.bits, self.bits_t, self.qh, self.kh,
                             self.vh, rm_cmp, self.H, self.scale,
                             self.orders, self.s)
        return den.t(), num.reshape(num.shape[0], self.H, -1).transpose(0, 1)


def dot_live_grid(adj, r_loc, c_loc, q, k, v, H: int, scale: float
                  ) -> DotLiveGrid:
    """The :class:`DotLiveGrid` of an unsharded resident layer: its live
    set (:func:`_live_set`, no own columns) and the present rows' ``q
    [nrows, H d]``, the present columns' ``k``, ``v [ncols, H d]``
    gathered."""
    bits, bits_t, orders = _live_set(adj, r_loc)
    return DotLiveGrid(bits=bits, bits_t=bits_t, orders=orders,
                       qh=_take_rows_fill(q, r_loc),
                       kh=_take_rows_fill(k, c_loc),
                       vh=_take_rows_fill(v, c_loc), H=H, scale=scale)
