"""Occupied-tile stream SpMM (K2): the counterpart of
`gnn_tpu.ops.pallas_spmm`.

Host side (numpy, the same arrays as the JAX package's packer):
:class:`StreamBlocks` and :func:`pack_stream` — dense ``(bm, bk)`` tiles
of an adjacency, only the occupied ones, ``blk_rc = rt << 16 | ct``
sorted by row tile, a zero sentinel tile for every empty row tile and
zero padding tiles at ``(n_rt - 1, 0)``. A stream may carry ``t_order``,
the column-tile visit order of its entries, for the transposed product.

Device side: :func:`stream_spmm` computes ``y = A @ x`` or, with
``transpose=True``, ``y = A^T @ x`` by launching the hand-written CUDA
kernel ``gnn_tpu_torch/csrc/stream_spmm.cu`` on CUDA tensors: a tile
scan that stages each tile in shared memory, lists its nonzeros and
multiplies only those (the main paths' tiles are 0.2-1% nonzero). On CPU
tensors it runs the plain PyTorch version :func:`stream_spmm_ref`
(per-tile ``bmm`` + ``index_add_``). :func:`blocked_spmm` runs it over
the per-row-tile layout of :class:`~gnn_tpu_torch.ops.sparse.BlockedAdj`.
:func:`plan` chooses a launch's F-chunk, rows a block and run split.

The TPU kernel's limits (``MAX_STREAM_BLOCKS``, the scalar-prefetch SMEM
cap, the 100 MiB VMEM check on the resident ``x`` block) do not apply on
the card and are not ported.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from gnn_tpu_torch.ops import cuda_build

# kernel launches by orientation ("forward" / "transpose"); incremented
# only where the CUDA kernel is launched. A launch recorded into a CUDA
# graph under capture counts in ``captured`` instead: it runs at each
# replay of the graph (`gnn_tpu_torch.train.dispatch` multiplies)
launches: collections.Counter = collections.Counter()
captured: collections.Counter = collections.Counter()

# thread blocks that fill the card: two waves of one resident block (256
# threads, ~200 KB of shared memory) on each of the H100's 132 SMs; below
# it the kernel splits each output tile's run of entries over up to
# MAX_SPLIT blocks
FILL_BLOCKS = 264
MAX_SPLIT = 16
# the F-chunks a block may own (floats; 640 fits a 602-wide input), and
# the floats of its output rows x chunk in shared memory (the kernel's
# ACC_FLOATS); a block owns at most MAX_ROWS output rows
CHUNKS = (128, 256, 512, 640, 1024)
ACC_FLOATS = 32768
MAX_ROWS = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class StreamBlocks:
    """Flattened occupied-tile stream of one adjacency (numpy on the
    host, tensors on the device)."""

    blk_rc: object    # int32 [NB] (row_tile << 16) | col_tile, rt-sorted
    vals: object      # f32 [NB, bm, bk] dense tile contents
    nrows: int
    ncols: int
    bm: int
    bk: int
    # int32 [NB]: the entries in (col tile, row tile) order, for the
    # transposed product (None: sorted on the device when needed)
    t_order: Optional[object] = None


def transpose_order(blk_rc: torch.Tensor) -> torch.Tensor:
    """Stable column-tile-major order of a stream's entries (int32)."""
    key = ((blk_rc.long() & 0xFFFF) << 16) | (blk_rc.long() >> 16)
    return torch.argsort(key, stable=True).to(torch.int32)


def pack_stream(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                nrows_pad: int, ncols_pad: int, bm: int = 8,
                bk: int = 128, nb_pad: Optional[int] = None,
                dtype=np.float32) -> StreamBlocks:
    """Host-side packing of COO edges into the sorted occupied-tile
    stream (the JAX package's arrays)."""
    assert nrows_pad % bm == 0 and ncols_pad % bk == 0
    n_rt, n_ct = nrows_pad // bm, ncols_pad // bk
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    # sentinel zero-value edge at (rt*bm, 0) for every empty row tile
    # (the TPU kernel zeroes an output block on its first visit; the CUDA
    # kernel writes every row without them, but the arrays stay the same)
    missing = np.setdiff1d(np.arange(n_rt, dtype=np.int64),
                           np.unique(rows // bm))
    if len(missing):
        rows = np.concatenate([rows, missing * bm])
        cols = np.concatenate([cols, np.zeros(len(missing), np.int64)])
        vals = np.concatenate([vals, np.zeros(len(missing), vals.dtype)])

    tr, tc = rows // bm, cols // bk
    key = tr * n_ct + tc
    order = np.argsort(key, kind="stable")
    uniq, counts = np.unique(key[order], return_counts=True)
    occ_tr = (uniq // n_ct).astype(np.int32)
    occ_tc = (uniq % n_ct).astype(np.int32)
    nb = len(uniq)
    if nb_pad is None:
        nb_pad = max(_round_up(nb, 8), 8)
    if nb > nb_pad:
        raise ValueError(f"{nb} blocks > pad {nb_pad}")

    assert n_rt < (1 << 15) and n_ct < (1 << 16), (n_rt, n_ct)
    blk_rc = np.full(nb_pad, max(n_rt - 1, 0) << 16, np.int32)
    blk_rc[:nb] = (occ_tr.astype(np.int32) << 16) | occ_tc
    tiles = np.zeros((nb_pad, bm, bk), dtype)

    edge_tile = np.repeat(np.arange(nb), counts)
    r_s, c_s, v_s = rows[order], cols[order], vals[order]
    tiles[edge_tile, r_s - (r_s // bm) * bm, c_s - (c_s // bk) * bk] = \
        v_s.astype(dtype)
    return StreamBlocks(blk_rc=blk_rc, vals=tiles, nrows=int(nrows_pad),
                        ncols=int(ncols_pad), bm=bm, bk=bk)


def stream_spmm_ref(stream: StreamBlocks, x: torch.Tensor,
                    transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`stream_spmm`: each tile times its
    slice of ``x`` (``bmm``), summed into the output tiles with
    ``index_add_``."""
    bm, bk = stream.bm, stream.bk
    rc = stream.blk_rc.long()
    rt, ct = rc >> 16, rc & 0xFFFF
    x = x.float()
    vals = stream.vals.float()
    f = x.shape[1]
    if transpose:
        xs = x.reshape(-1, bm, f).index_select(0, rt)      # [NB, bm, F]
        prod = torch.bmm(vals.transpose(1, 2), xs)         # [NB, bk, F]
        y = x.new_zeros((stream.ncols // bk, bk, f)).index_add_(0, ct, prod)
        return y.reshape(stream.ncols, f)
    xs = x.reshape(-1, bk, f).index_select(0, ct)          # [NB, bk, F]
    prod = torch.bmm(vals, xs)                             # [NB, bm, F]
    y = x.new_zeros((stream.nrows // bm, bm, f)).index_add_(0, rt, prod)
    return y.reshape(stream.nrows, f)


def _kernel():
    fn = cuda_build.load("stream_spmm").stream_spmm_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = i
    return fn


def check_tensor(op, name, t, dtype, device, shape=None):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    (of ``shape`` when given): what the CUDA kernels take."""
    if t.device != device:
        raise ValueError(f"{op}: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{op}: {name} is {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} is not contiguous")


def n_split(n_blocks: int, nb: int, n_tiles: int) -> int:
    """Parts to split each output tile's run into: enough that
    ``n_blocks`` x parts reaches ``FILL_BLOCKS``, at most ``MAX_SPLIT``
    and at most the mean run length (``nb / n_tiles`` entries)."""
    if n_blocks >= FILL_BLOCKS:
        return 1
    return max(1, min(MAX_SPLIT, -(-FILL_BLOCKS // max(n_blocks, 1)),
                      nb // max(n_tiles, 1)))


def plan(n_tiles: int, b_out: int, f: int, nb: int):
    """``(chunk, rows, nsplit)`` of one K2 launch over ``n_tiles`` output
    tiles of ``b_out`` rows at width ``f``, ``nb`` entries: the F-chunk a
    block owns (the narrowest of ``CHUNKS`` that holds ``f``, else the
    widest), the output rows it owns (the largest power of two up to
    ``MAX_ROWS`` whose rows x chunk fit ``ACC_FLOATS``), and the parts
    each run is split into (:func:`n_split` of the blocks: tiles x row
    parts x chunks)."""
    chunk = next((c for c in CHUNKS if c >= f), CHUNKS[-1])
    rows = MAX_ROWS
    while rows > 1 and rows * chunk > ACC_FLOATS:
        rows //= 2
    blocks = n_tiles * -(-b_out // rows) * -(-f // chunk)
    return chunk, rows, n_split(blocks, nb, n_tiles)


def _launch(stream: StreamBlocks, x: torch.Tensor, transpose: bool
            ) -> torch.Tensor:
    dev = x.device
    bm, bk = stream.bm, stream.bk
    nb = stream.blk_rc.shape[0]
    n_in = stream.nrows if transpose else stream.ncols
    n_out = stream.ncols if transpose else stream.nrows
    check_tensor("stream_spmm", "x", x, torch.float32, dev,
                 (n_in, x.shape[1]))
    check_tensor("stream_spmm", "blk_rc", stream.blk_rc, torch.int32, dev,
                 (nb,))
    check_tensor("stream_spmm", "vals", stream.vals, torch.float32, dev,
                 (nb, bm, bk))
    # the kernel stages tiles with 16-byte bulk copies
    if stream.vals.data_ptr() % 16:
        raise ValueError("stream_spmm: vals is not 16-byte aligned (a "
                         "view at an offset); pass an aligned tensor")
    if bk % 4:
        raise ValueError(f"stream_spmm: bk = {bk} is not a multiple of 4")
    t_order = None
    if transpose:
        t_order = stream.t_order
        if t_order is None:
            t_order = transpose_order(stream.blk_rc)
        check_tensor("stream_spmm", "t_order", t_order, torch.int32, dev,
                     (nb,))
    f = x.shape[1]
    b_out = bk if transpose else bm
    n_tiles = n_out // b_out
    chunk, rows, nsplit = plan(n_tiles, b_out, f, nb)
    y = torch.empty((n_out, f), dtype=torch.float32, device=dev)
    parts = (torch.empty((nsplit, n_out, f), dtype=torch.float32,
                         device=dev) if nsplit > 1 else None)
    err = _kernel()(stream.vals.data_ptr(), stream.blk_rc.data_ptr(),
                    None if t_order is None else t_order.data_ptr(), nb,
                    x.data_ptr(), y.data_ptr(),
                    None if parts is None else parts.data_ptr(), n_tiles, f,
                    bm, bk, int(transpose), nsplit, chunk, rows,
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stream_spmm: CUDA launch failed "
                           f"(cudaError {err})")
    cuda_build.count_launch(launches, captured,
                            "transpose" if transpose else "forward")
    return y


def stream_spmm(stream: StreamBlocks, x: torch.Tensor,
                transpose: bool = False) -> torch.Tensor:
    """``y[nrows, F] = A @ x`` (or ``y[ncols, F] = A^T @ x``) with A given
    as an occupied-tile stream whose entries are sorted by row tile.
    Output float32.

    CUDA tensors launch the hand-written kernel (float32 products of the
    tiles' nonzeros only; bitwise the same from call to call); CPU
    tensors take the plain version; any other device raises."""
    n_in = stream.nrows if transpose else stream.ncols
    if x.dim() != 2 or x.shape[0] != n_in:
        raise ValueError(f"stream_spmm: x has shape {tuple(x.shape)}, "
                         f"expected ({n_in}, F)")
    if x.device.type == "cpu":
        return stream_spmm_ref(stream, x, transpose)
    if x.device.type != "cuda":
        raise ValueError(f"stream_spmm: unsupported device {x.device}")
    return _launch(stream, x.float().contiguous(), transpose)


def _blocked_to_stream_arrays(block_cols: torch.Tensor,
                              block_vals: torch.Tensor):
    """Flatten a ``[n_rt, max_blk]`` per-row-tile layout into stream
    arrays (reshapes, no copy of the tiles)."""
    n_rt, max_blk = block_cols.shape
    blk_row = torch.arange(n_rt, dtype=torch.int32,
                           device=block_cols.device).repeat_interleave(
                               max_blk)
    blk_rc = (blk_row << 16) | block_cols.reshape(-1).to(torch.int32)
    vals = block_vals.reshape((-1,) + tuple(block_vals.shape[2:]))
    return blk_rc, vals


def blocked_spmm(block_cols, block_vals, x: torch.Tensor, bm: int,
                 bk: int) -> torch.Tensor:
    """SpMM over the BlockedAdj layout through :func:`stream_spmm`.

    Padding tiles have zero values and add nothing; the kernel writes
    every output row whatever the layout holds."""
    n_rt = block_cols.shape[0]
    blk_rc, vals = _blocked_to_stream_arrays(block_cols, block_vals)
    stream = StreamBlocks(blk_rc=blk_rc, vals=vals, nrows=n_rt * bm,
                          ncols=x.shape[0], bm=bm, bk=bk)
    return stream_spmm(stream, x)
