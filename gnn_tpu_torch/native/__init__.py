"""JIT-built native host sampling core (ctypes) — a copy of
`gnn_tpu.native`, so the port draws the same random numbers without
importing the JAX package.

Mirrors the reference's import-time JIT build of its native extension
(reference `custom_sparse_ops.py:8`), but with g++ + ctypes instead
of a CUDA/pybind11 toolchain, and with a clean numpy fallback: importers
call :func:`get_lib` and get ``None`` when no compiler is available.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "sampler_core.cpp")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build(so_path: str) -> None:
    # build to a pid-suffixed temp + atomic rename: multi-controller
    # runs start several processes at once and a half-written .so must
    # never be dlopen'd by a sibling
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
           "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """Load (building if needed) the native library; None on failure."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            with open(_SRC, "rb") as f:
                tag = hashlib.sha1(f.read()).hexdigest()[:12]
            cache = os.environ.get(
                "GNN_TPU_TORCH_NATIVE_CACHE",
                os.path.join(os.path.expanduser("~"), ".cache",
                             "gnn_tpu_torch"))
            os.makedirs(cache, exist_ok=True)
            so_path = os.path.join(cache, f"sampler_core_{tag}.so")
            if not os.path.exists(so_path):
                _build(so_path)
            lib = ctypes.CDLL(so_path)
            _declare(lib)
            _LIB = lib
        except Exception as e:  # pragma: no cover - env without g++
            import warnings
            warnings.warn(f"native sampler core unavailable ({e}); "
                          f"falling back to numpy")
            _LIB = None
        return _LIB


def _declare(lib) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.count_cols.argtypes = [i64p, i32p, i32p, ctypes.c_int64,
                               ctypes.c_int64, f64p]
    lib.count_cols.restype = None
    lib.scale_skew.argtypes = [f64p, i32p, ctypes.c_int64, ctypes.c_double]
    lib.scale_skew.restype = None
    lib.gumbel_topk.argtypes = [f64p, ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_uint64, i32p]
    lib.gumbel_topk.restype = ctypes.c_int64
    lib.slice_cols_count.argtypes = [i64p, i32p, i32p, ctypes.c_int64,
                                     i32p, i64p]
    lib.slice_cols_count.restype = None
    lib.slice_cols_fill.argtypes = [i64p, i32p, f32p, i32p, ctypes.c_int64,
                                    i32p, f32p, i64p, i32p, i32p, f32p]
    lib.slice_cols_fill.restype = None
    lib.prefix_sum.argtypes = [i64p, ctypes.c_int64, i64p]
    lib.prefix_sum.restype = None
    lib.set_threads.argtypes = [ctypes.c_int]
    lib.set_threads.restype = None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.hot_split.argtypes = [i32p, i32p, f32p, ctypes.c_int64, u8p, u8p,
                              ctypes.c_int64, i32p, i32p, f32p, i32p,
                              i32p, f32p]
    lib.hot_split.restype = ctypes.c_int64
    lib.slice_cols_count_cold.argtypes = [i64p, i32p, i32p,
                                          ctypes.c_int64, i32p, u8p, u8p,
                                          i64p]
    lib.slice_cols_count_cold.restype = None
    lib.slice_cols_fill_cold.argtypes = [i64p, i32p, f32p, i32p,
                                         ctypes.c_int64, i32p, f32p, u8p,
                                         u8p, i64p, i32p, i32p, f32p]
    lib.slice_cols_fill_cold.restype = None
    lib.slice_cols_cold_fused.argtypes = [i64p, i32p, f32p, i32p,
                                          ctypes.c_int64, i32p, f32p,
                                          u8p, u8p, ctypes.c_int64,
                                          i32p, i32p, f32p, i32p]
    lib.slice_cols_cold_fused.restype = ctypes.c_int64
    lib.slice_cols_cold_fused_split.argtypes = [
        i64p, i64p, i32p, f32p, i32p, ctypes.c_int64, i32p, f32p, u8p,
        ctypes.c_int64, i32p, i32p, f32p, i32p]
    lib.slice_cols_cold_fused_split.restype = ctypes.c_int64
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.pack_tiles.argtypes = [i32p, i32p, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int, ctypes.c_int, i32p, i16p]
    lib.pack_tiles.restype = None
    lib.slice_cols_cold_tiles.argtypes = [
        i64p, i64p, i32p, i32p, ctypes.c_int64, i32p, u8p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, i32p, i16p]
    lib.slice_cols_cold_tiles.restype = ctypes.c_int64
    lib.pack_tiles_perm.argtypes = [i32p, i32p, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int, ctypes.c_int, i32p,
                                    i16p, i32p]
    lib.pack_tiles_perm.restype = None


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


class NativeCSR:
    """A CSR graph pinned in the dtypes the native core expects."""

    def __init__(self, csr):
        self.indptr = np.ascontiguousarray(csr.indptr, np.int64)
        self.indices = np.ascontiguousarray(csr.indices, np.int32)
        self.data = np.ascontiguousarray(csr.data, np.float32)
        self.shape = csr.shape
        self._split = None          # (mask_token, indices2, data2, hsplit)
        self._split_lock = threading.Lock()

    def ensure_split(self, hot_node: np.ndarray):
        """Lazily build the column-hotness-split copy: per row, cold-col
        edges first, then hot-col edges; ``hsplit[r]`` = absolute index
        of the first hot-col edge. Hot rows' cold extraction then skips
        their hot-col (= hot-hot) edges entirely — the hub-hub bulk of
        the scan. One stable 2-key sort of the edge list, built once
        per (graph, hot set) and cached on this object."""
        token = (hot_node.__array_interface__["data"][0], len(hot_node),
                 int(hot_node.sum()))
        if self._split is not None and self._split[0] == token:
            return self._split[1:]
        with self._split_lock:
            if self._split is not None and self._split[0] == token:
                return self._split[1:]
            return self._build_split(hot_node, token)

    def _build_split(self, hot_node, token):
        n = self.shape[0]
        lens = np.diff(self.indptr)
        row_of = np.repeat(np.arange(n, dtype=np.int64), lens)
        hot_e = hot_node[self.indices].astype(np.int64)
        order = np.argsort(row_of * 2 + hot_e, kind="stable")
        indices2 = np.ascontiguousarray(self.indices[order])
        data2 = np.ascontiguousarray(self.data[order])
        ncold = np.bincount(row_of, weights=(1 - hot_e),
                            minlength=n).astype(np.int64)
        hsplit = np.ascontiguousarray(self.indptr[:-1] + ncold)
        self._split = (token, indices2, data2, hsplit)
        return indices2, data2, hsplit


_SPLIT_BUFS = threading.local()


def _split_buffers(nnz: int):
    """Per-thread reusable output buffers for hot_split: fresh np.empty
    allocations page-fault ~10x the C kernel's own cost at minibatch
    scale (measured 165 vs 15 ms), and pipeline workers call this every
    layer. The returned views are copied into padded arrays by the
    caller before its next call, so reuse is safe."""
    cur = getattr(_SPLIT_BUFS, "bufs", None)
    if cur is None or cur[0].shape[0] < nnz:
        cap = max(int(nnz * 1.25), 1 << 16)
        cur = (np.empty(cap, np.int32), np.empty(cap, np.int32),
               np.empty(cap, np.float32), np.empty(cap, np.int32),
               np.empty(cap, np.int32), np.empty(cap, np.float32))
        _SPLIT_BUFS.bufs = cur
    return cur


def hot_split_native(lib, rows: np.ndarray, cols: np.ndarray,
                     vals: np.ndarray, hot_row: np.ndarray,
                     hot_col: np.ndarray, n_cols: int):
    """Cold-edge extraction (row order preserved) + col-sorted transpose
    copy in one native call; see `sampler_core.cpp::hot_split`."""
    nnz = len(rows)
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float32)
    hot_row = np.ascontiguousarray(hot_row, np.uint8)
    hot_col = np.ascontiguousarray(hot_col, np.uint8)
    cr, cc, cv, crt, cct, cvt = _split_buffers(nnz)
    u8 = ctypes.c_uint8
    n_cold = lib.hot_split(
        _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
        _ptr(vals, ctypes.c_float), ctypes.c_int64(nnz),
        _ptr(hot_row, u8), _ptr(hot_col, u8), ctypes.c_int64(n_cols),
        _ptr(cr, ctypes.c_int32), _ptr(cc, ctypes.c_int32),
        _ptr(cv, ctypes.c_float), _ptr(crt, ctypes.c_int32),
        _ptr(cct, ctypes.c_int32), _ptr(cvt, ctypes.c_float))
    n_cold = int(n_cold)
    return (cr[:n_cold], cc[:n_cold], cv[:n_cold],
            crt[:n_cold], cct[:n_cold], cvt[:n_cold])


_TILE_BUFS = threading.local()


def _tile_buffer(n: int) -> np.ndarray:
    """Per-thread reusable int16 coord scratch (same first-touch
    page-fault rationale as `_split_buffers`; the caller copies the
    result into its padded payload array before the next call)."""
    cur = getattr(_TILE_BUFS, "buf", None)
    if cur is None or cur.shape[0] < n:
        cur = np.empty(max(int(n * 1.25), 1 << 16), np.int16)
        _TILE_BUFS.buf = cur
    return cur


def slice_cold_tiles_native(lib, graph: "NativeCSR", prev: np.ndarray,
                            pos: np.ndarray, hot_node: np.ndarray,
                            n_rt: int, n_ct: int, log2_bm: int,
                            log2_bk: int):
    """Cold extraction STRAIGHT to tile-grouped int16 coords + per-tile
    counts in one native scan (`sampler_core.cpp::slice_cols_cold_tiles`)
    — the stream-tiles payload without materializing rows/cols/vals.
    Returns ``(coords[:n_cold] view, tile_cnt int32[n_rt*n_ct])``."""
    prev = np.ascontiguousarray(prev, np.int32)
    hot_prev = np.ascontiguousarray(hot_node[prev], np.uint8)
    idx2, _, hsplit = graph.ensure_split(hot_node)
    tile_cnt = np.zeros(n_rt * n_ct, np.int32)
    buf = _tile_buffer(1 << 16)
    c_i64 = ctypes.c_int64
    while True:
        cap = buf.shape[0]
        n_cold = int(lib.slice_cols_cold_tiles(
            _ptr(graph.indptr, ctypes.c_int64),
            _ptr(hsplit, ctypes.c_int64), _ptr(idx2, ctypes.c_int32),
            _ptr(prev, ctypes.c_int32), c_i64(len(prev)),
            _ptr(pos, ctypes.c_int32),
            _ptr(hot_prev, ctypes.c_uint8), c_i64(n_ct),
            c_i64(n_rt * n_ct), ctypes.c_int(log2_bm),
            ctypes.c_int(log2_bk), c_i64(cap),
            _ptr(tile_cnt, ctypes.c_int32),
            _ptr(buf, ctypes.c_int16)))
        if n_cold >= 0:
            return buf[:n_cold], tile_cnt
        tile_cnt[:] = 0
        buf = _tile_buffer(-n_cold)


def pack_tiles_native(lib, rows: np.ndarray, cols: np.ndarray,
                      n_rt: int, n_ct: int, log2_bm: int, log2_bk: int):
    """Counting-sort a local-id COO into tile-major order: packed int16
    coords ``(lr << 8) | lc`` plus per-tile counts (dense [n_rt*n_ct]).
    ~2 ms at canonical cold-layer scale vs ~75 ms for the numpy argsort
    (`pallas_edgestream.pack_edge_tiles`)."""
    e = len(rows)
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    tile_cnt = np.zeros(n_rt * n_ct, np.int32)
    coords = np.empty(e, np.int16)
    lib.pack_tiles(_ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
                   ctypes.c_int64(e), ctypes.c_int64(n_ct),
                   ctypes.c_int64(n_rt * n_ct), ctypes.c_int(log2_bm),
                   ctypes.c_int(log2_bk), _ptr(tile_cnt, ctypes.c_int32),
                   _ptr(coords, ctypes.c_int16))
    return coords, tile_cnt


def pack_tiles_perm_native(lib, rows: np.ndarray, cols: np.ndarray,
                           n_rt: int, n_ct: int, log2_bm: int,
                           log2_bk: int):
    """`pack_tiles_native` + the tile-order permutation (``perm[w]`` =
    input index of the edge at output slot w) — for reordering per-edge
    VALUES into tile order (weighted edge-stream payload)."""
    e = len(rows)
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    tile_cnt = np.zeros(n_rt * n_ct, np.int32)
    coords = np.empty(e, np.int16)
    perm = np.empty(e, np.int32)
    lib.pack_tiles_perm(
        _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
        ctypes.c_int64(e), ctypes.c_int64(n_ct),
        ctypes.c_int64(n_rt * n_ct), ctypes.c_int(log2_bm),
        ctypes.c_int(log2_bk), _ptr(tile_cnt, ctypes.c_int32),
        _ptr(coords, ctypes.c_int16), _ptr(perm, ctypes.c_int32))
    return coords, tile_cnt, perm


def sample_columns_native(lib, graph: NativeCSR, prev: np.ndarray,
                          samp_num: int, seed: int,
                          skew: np.ndarray | None = None,
                          scale_factor: float = 1.0):
    """Column-probability build + Gumbel top-k sample + debias vector
    (the sampling half of `sampler.py:113-131`): returns
    ``(after, normfact, pos)`` with ``pos`` the global->local column
    map (-1 = not sampled). Shared by the LADIES per-layer step and the
    subgraph sampler's one-shot sample."""
    n = graph.shape[1]
    prev = np.ascontiguousarray(prev, np.int32)
    pi = np.zeros(n, np.float64)
    c_i64 = ctypes.c_int64
    lib.count_cols(_ptr(graph.indptr, ctypes.c_int64),
                   _ptr(graph.indices, ctypes.c_int32),
                   _ptr(prev, ctypes.c_int32), c_i64(len(prev)), c_i64(n),
                   _ptr(pi, ctypes.c_double))
    if skew is not None and scale_factor > 1.0:
        skew = np.ascontiguousarray(skew, np.int32)
        lib.scale_skew(_ptr(pi, ctypes.c_double),
                       _ptr(skew, ctypes.c_int32), c_i64(len(skew)),
                       ctypes.c_double(scale_factor))
    chosen = np.empty(samp_num, np.int32)
    got = lib.gumbel_topk(_ptr(pi, ctypes.c_double), c_i64(n),
                          c_i64(samp_num), ctypes.c_uint64(seed),
                          _ptr(chosen, ctypes.c_int32))
    s_num = int(got)
    after = np.union1d(chosen[:s_num], prev).astype(np.int64)

    p_total = pi.sum()
    p_after = pi[after] / max(p_total, 1e-300)
    normfact = (1.0 / np.clip(s_num * p_after, 1e-10, 1.0)).astype(
        np.float32)

    pos = np.full(n, -1, np.int32)
    pos[after] = np.arange(len(after), dtype=np.int32)
    return after, normfact, pos


def slice_rows_native(lib, graph: NativeCSR, row_set: np.ndarray,
                      pos: np.ndarray, normfact: np.ndarray,
                      hot_node: np.ndarray | None = None,
                      tile_spec: tuple | None = None):
    """COO (or stream-tile coords) of ``A[row_set][:, sampled]`` with
    final edge weights — the slicing half of a sampler layer, shared by
    LADIES (rows = prev) and the subgraph sampler (first layer rows =
    prev, deeper layers rows = after).

    ``hot_node`` (uint8[N], resident-lite mode): emit ONLY the cold
    edges (row or col not hot) — the hot-hot ones live in the
    device-resident dense block and never need host materialization.

    ``tile_spec`` = ``(n_rt, n_ct, log2_bm, log2_bk)`` (stream-tiles
    payload; needs ``hot_node``): skip the COO entirely — the cold
    edges go STRAIGHT to tile-grouped packed coords in one scan, and
    the return is ``(coords_view, tile_cnt)``.
    """
    row_set = np.ascontiguousarray(row_set, np.int32)
    c_i64 = ctypes.c_int64
    if tile_spec is not None:
        assert hot_node is not None, "tile_spec needs hot_node"
        n_rt, n_ct, log2_bm, log2_bk = tile_spec
        return slice_cold_tiles_native(
            lib, graph, row_set, pos, hot_node, n_rt, n_ct, log2_bm,
            log2_bk)
    u8 = ctypes.c_uint8
    if hot_node is not None:
        # fused single-scan cold extraction (count + fill + per-row
        # counts in one pass over the row spans); reusable per-thread
        # buffers avoid the ~70 us/page first-touch tax
        hot_prev = np.ascontiguousarray(hot_node[row_set], np.uint8)
        rowcnt = np.empty(len(row_set), np.int32)
        idx2, dat2, hsplit = graph.ensure_split(hot_node)
        br, bc, bv, _, _, _ = _split_buffers(1 << 16)
        while True:
            cap = len(br)
            n_cold = int(lib.slice_cols_cold_fused_split(
                _ptr(graph.indptr, ctypes.c_int64),
                _ptr(hsplit, ctypes.c_int64),
                _ptr(idx2, ctypes.c_int32), _ptr(dat2, ctypes.c_float),
                _ptr(row_set, ctypes.c_int32), c_i64(len(row_set)),
                _ptr(pos, ctypes.c_int32), _ptr(normfact, ctypes.c_float),
                _ptr(hot_prev, u8), c_i64(cap),
                _ptr(br, ctypes.c_int32), _ptr(bc, ctypes.c_int32),
                _ptr(bv, ctypes.c_float), _ptr(rowcnt, ctypes.c_int32)))
            if n_cold >= 0:
                break
            br, bc, bv, _, _, _ = _split_buffers(-n_cold)
        return br[:n_cold], bc[:n_cold], bv[:n_cold]
    rowlen = np.empty(len(row_set), np.int64)
    lib.slice_cols_count(_ptr(graph.indptr, ctypes.c_int64),
                         _ptr(graph.indices, ctypes.c_int32),
                         _ptr(row_set, ctypes.c_int32), c_i64(len(row_set)),
                         _ptr(pos, ctypes.c_int32),
                         _ptr(rowlen, ctypes.c_int64))
    row_off = np.empty(len(row_set) + 1, np.int64)
    lib.prefix_sum(_ptr(rowlen, ctypes.c_int64), c_i64(len(row_set)),
                   _ptr(row_off, ctypes.c_int64))
    nnz = int(row_off[-1])
    rows = np.empty(nnz, np.int32)
    cols = np.empty(nnz, np.int32)
    vals = np.empty(nnz, np.float32)
    lib.slice_cols_fill(_ptr(graph.indptr, ctypes.c_int64),
                        _ptr(graph.indices, ctypes.c_int32),
                        _ptr(graph.data, ctypes.c_float),
                        _ptr(row_set, ctypes.c_int32), c_i64(len(row_set)),
                        _ptr(pos, ctypes.c_int32),
                        _ptr(normfact, ctypes.c_float),
                        _ptr(row_off, ctypes.c_int64),
                        _ptr(rows, ctypes.c_int32),
                        _ptr(cols, ctypes.c_int32),
                        _ptr(vals, ctypes.c_float))
    return rows, cols, vals


def ladies_layer_native(lib, graph: NativeCSR, prev: np.ndarray,
                        samp_num: int, seed: int,
                        skew: np.ndarray | None = None,
                        scale_factor: float = 1.0,
                        hot_node: np.ndarray | None = None,
                        tile_spec: tuple | None = None):
    """One LADIES layer step, fully in native code.

    Returns (after, normfact, rows, cols, vals): the sampled node set,
    debias vector, and the COO of ``A[prev][:, after]`` with final edge
    weights — the exact quantities of `sampler.py:113-139`. With
    ``tile_spec`` (see :func:`slice_rows_native`), returns
    ``(after, normfact, coords_view, tile_cnt)`` instead.
    """
    after, normfact, pos = sample_columns_native(
        lib, graph, prev, samp_num, seed, skew, scale_factor)
    out = slice_rows_native(lib, graph, prev, pos, normfact,
                            hot_node=hot_node, tile_spec=tile_spec)
    return (after, normfact) + tuple(out)
