"""LADIES layer-wise importance sampling and the subgraph sampler (host
side): the counterpart of `gnn_tpu.sampling.ladies`, drawing the same
random numbers.

Per layer: slice ``U = lap[prev, :]``; column probability = column nnz
counts of ``U`` (reference ``sampler.py:117``), optionally skewed; sample
``min(nnz(p), samp_num)`` columns without replacement (Gumbel top-k);
union with ``prev``; debias by ``normfact = 1/clip(s_num * p, 1e-10, 1)``.
Every layer is padded to a static node cap and each edge list to a
bucketed size, exactly as the JAX package pads them, so both packages
produce bit-identical batches from one seed. The native C++ core and the
numpy fallback draw DIFFERENT numbers (each is deterministic), so batch
identity with the JAX package needs both on the same path.

Formats: ``coo``, ``blocked`` (tiled, K2), ``pattern`` (GAT's
pattern-only transport), ``hot`` (host-packed hot-block plumbing + cold
COO) and ``resident``. The subgraph sampler (:func:`subgraph_sample`)
samples one node set for the top layer; every deeper layer is the same
square adjacency, packed once and shared.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import scipy.sparse as sp

from gnn_tpu_torch.ops import sparse as sparse_ops

_NATIVE_GRAPHS: dict = {}


def _native_graph(lap):
    """Cache a NativeCSR view of a laplacian (weakref-keyed by id)."""
    import weakref

    from gnn_tpu_torch import native as _native
    lib = _native.get_lib()
    if lib is None:
        return None, None
    key = id(lap)
    entry = _NATIVE_GRAPHS.get(key)
    if entry is not None and entry[0]() is lap:
        return lib, entry[1]

    def _evict(_ref, _key=key):
        _NATIVE_GRAPHS.pop(_key, None)

    ncsr = _native.NativeCSR(lap)
    _NATIVE_GRAPHS[key] = (weakref.ref(lap, _evict), ncsr)
    return lib, ncsr


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_size(n: int, minimum: int = 1024) -> int:
    """Round up to a geometric bucket (~1.3x steps)."""
    b = minimum
    while b < n:
        b = _round_up(int(b * 1.3) + 1, 256)
    return b


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Static sampling configuration (defines all padded shapes)."""

    batch_size: int
    samp_num: int
    orders: Sequence[int]          # per-layer aggregation order, bottom-up
    num_nodes: int
    num_classes: int
    sampler: str = "ladies"
    scale_factor: float = 1.0
    # 'coo' | 'blocked' | 'pattern' | 'hot' | 'resident'
    adj_format: str = "coo"
    hot_spec: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)
    node_pad_multiple: int = 128
    # int16 indices + bfloat16-rounded values where they fit
    compress: bool = True
    resident_ship_cold: bool = True
    # rank-1 (binary adjacency) laplacian: cold values recompute on the
    # device and never ship
    resident_val_free: bool = False
    # ship the cold residual as packed tiles for the edge-stream kernel
    resident_stream_tiles: bool = False
    # tile shape of the blocked format
    bm: int = 128
    bk: int = 128

    def layer_caps(self) -> List[int]:
        """Static per-level node-count caps, bottom-up (level L = the
        batch); each order>0 layer adds at most ``samp_num`` nodes."""
        if self.sampler == "subgraph":
            cap = _round_up(self.batch_size + self.samp_num,
                            self.node_pad_multiple)
            return [cap] * (len(list(self.orders)) + 1)
        caps_td = [self.batch_size]
        m = self.batch_size
        for order in reversed(list(self.orders)):
            if order > 0:
                m = m + self.samp_num
            caps_td.append(m)
        caps = caps_td[::-1]
        return [_round_up(c, self.node_pad_multiple) for c in caps]


@dataclasses.dataclass
class MiniBatch:
    """One sampled, padded minibatch (host numpy). ``adjs[l]`` is None
    for order-0 layers."""

    adjs: List[Optional[object]]
    sampled_nodes: List[np.ndarray]     # int32 [R_cap_l] per layer
    input_nodes: np.ndarray             # int32 [C_cap_0] (padded 0)
    n_input: int
    input_mask: np.ndarray              # f32 [C_cap_0]
    labels: np.ndarray                  # f32 [B_cap, num_classes]
    label_mask: np.ndarray              # f32 [B_cap]
    batch_nodes: np.ndarray             # int32 [B_cap]


def _gumbel_topk_without_replacement(rng: np.random.Generator,
                                     p: np.ndarray, k: int) -> np.ndarray:
    """k indices without replacement ~ successive sampling by p."""
    pos = np.flatnonzero(p > 0)
    if k >= len(pos):
        return pos
    logp = np.log(p[pos])
    gumbel = -np.log(-np.log(rng.random(len(pos)) + 1e-300) + 1e-300)
    keys = logp + gumbel
    top = np.argpartition(-keys, k - 1)[:k]
    return pos[top]


def _slice_cols_to_coo(U: sp.csr_matrix, after: np.ndarray,
                       normfact: np.ndarray):
    """COO of ``U[:, after]`` with edge weights ``U.data * normfact``."""
    n = U.shape[1]
    pos = np.full(n, -1, np.int64)
    pos[after] = np.arange(len(after))
    row_of_nnz = np.repeat(np.arange(U.shape[0]), np.diff(U.indptr))
    new_col = pos[U.indices]
    keep = new_col >= 0
    rows = row_of_nnz[keep].astype(np.int32)
    cols = new_col[keep].astype(np.int32)
    vals = (U.data[keep] * normfact[cols]).astype(np.float32)
    return rows, cols, vals


def _pack_adj(cfg: SamplerConfig, rows, cols, vals, n_rows, n_cols,
              r_cap, c_cap, prev=None, after=None, normfact=None,
              lap_indptr=None, cold_precomputed=False, tiles_pre=None):
    if cfg.adj_format == "resident":
        if cfg.hot_spec is None:
            raise ValueError("adj_format='resident' needs "
                             "SamplerConfig.hot_spec")
        from gnn_tpu_torch.ops.residentgraph import pack_resident_ref
        return pack_resident_ref(cfg.hot_spec, lap_indptr, prev, after,
                                 normfact, rows, cols, n_rows, n_cols,
                                 r_cap, c_cap, vals=vals,
                                 ship_cold=cfg.resident_ship_cold,
                                 compress=cfg.compress,
                                 cold_precomputed=cold_precomputed,
                                 val_free=cfg.resident_val_free,
                                 stream_tiles=cfg.resident_stream_tiles,
                                 tiles_pre=tiles_pre)
    if cfg.adj_format == "pattern":
        # attention transport: values never ship (GAT computes per-edge
        # scores on the device); cols int16 + per-row counts only
        nnz_pad = bucket_size(max(len(rows), 1))
        return sparse_ops.pack_pattern(rows, cols, n_rows, n_cols,
                                       r_cap, c_cap, nnz_pad,
                                       compress=cfg.compress)
    if cfg.adj_format == "blocked":
        return sparse_ops.pack_blocked(rows, cols, vals, n_rows, n_cols,
                                       r_cap, c_cap, bm=cfg.bm, bk=cfg.bk)
    if cfg.adj_format == "hot":
        if cfg.hot_spec is None:
            raise ValueError("adj_format='hot' needs SamplerConfig.hot_spec "
                             "(see gnn_tpu_torch.ops.hotdense.HotSpec)")
        from gnn_tpu_torch.ops.hotdense import pack_hotdense
        return pack_hotdense(cfg.hot_spec, rows, cols, vals, prev, after,
                             normfact, n_rows, n_cols, r_cap, c_cap,
                             compress=cfg.compress)
    if cfg.adj_format == "coo":
        nnz_pad = bucket_size(max(len(rows), 1))
        return sparse_ops.pack_coo(rows, cols, vals, n_rows, n_cols,
                                   r_cap, c_cap, nnz_pad,
                                   compress=cfg.compress)
    raise ValueError(f"unknown adj_format {cfg.adj_format!r}")


def _layer_probability(U: sp.csr_matrix, skew_nodes, scale_factor):
    """Column sampling probability = col nnz counts, optionally skewed."""
    pi = np.bincount(U.indices, minlength=U.shape[1]).astype(np.float64)
    if scale_factor > 1 and skew_nodes is not None:
        pi[skew_nodes] = pi[skew_nodes] * scale_factor
    return pi / pi.sum()


def _cold_only_mask(cfg: SamplerConfig, lib):
    """uint8 hot-node mask when the native slice should emit only cold
    edges (resident-lite), else None. Cached on the (frozen) HotSpec so
    the same array rides every call: NativeCSR.ensure_split keys its
    split copy on it."""
    if (lib is None or cfg.adj_format != "resident"
            or not cfg.resident_ship_cold or cfg.hot_spec is None):
        return None
    hot_node = getattr(cfg.hot_spec, "_hot_mask", None)
    if hot_node is None:
        hot_node = (cfg.hot_spec.slot_of_node >= 0).astype(np.uint8)
        object.__setattr__(cfg.hot_spec, "_hot_mask", hot_node)
    return hot_node


def _tile_spec(cfg: SamplerConfig, hot_node, r_cap: int, c_cap: int):
    """The native direct-to-tiles spec ``(n_rt, n_ct, log2 bm, log2 bk)``
    and ``(bm, bk)`` when the cold slice should emit packed coords, else
    ``(None, None)``."""
    if not (hot_node is not None and cfg.resident_stream_tiles
            and cfg.resident_val_free):
        return None, None
    from gnn_tpu_torch.ops.edgestream import tile_dims
    es_bm, es_bk = tile_dims(r_cap, c_cap)
    return (r_cap // es_bm, c_cap // es_bk, es_bm.bit_length() - 1,
            es_bk.bit_length() - 1), (es_bm, es_bk)


def ladies_sample(cfg: SamplerConfig, seed: int, batch_nodes: np.ndarray,
                  lap_matrix: sp.csr_matrix, labels_full: sp.csr_matrix,
                  skewed_sampling_nodes: Optional[List[np.ndarray]] = None,
                  ) -> MiniBatch:
    """LADIES sampler (reference ``sampler.py:90-160``), padded."""
    rng = np.random.default_rng(seed)
    caps = cfg.layer_caps()
    orders_td = list(cfg.orders)[::-1]
    n_layers = len(orders_td)

    prev = np.asarray(batch_nodes, dtype=np.int64)
    adjs: List[Optional[object]] = []
    sampled: List[np.ndarray] = []
    lib, ngraph = _native_graph(lap_matrix)
    hot_node = _cold_only_mask(cfg, lib)

    for d in range(n_layers):
        li = n_layers - d - 1
        r_cap, c_cap = caps[li + 1], caps[li]
        if orders_td[d] == 0:
            adjs.append(None)
            sampled.append(np.zeros(r_cap, np.int32))
            continue
        skew = None
        if skewed_sampling_nodes is not None:
            skew = skewed_sampling_nodes[li]
        tiles_pre = None
        if lib is not None:
            from gnn_tpu_torch.native import ladies_layer_native
            # direct-to-tiles: the cold slice emits packed coords
            tile_spec, es_dims = _tile_spec(cfg, hot_node, r_cap, c_cap)
            out = ladies_layer_native(
                lib, ngraph, prev, cfg.samp_num,
                int(rng.integers(2 ** 63 - 1)), skew, cfg.scale_factor,
                hot_node=hot_node, tile_spec=tile_spec)
            if tile_spec is not None:
                after, normfact, coords, tile_cnt = out
                tiles_pre = (coords, tile_cnt, *es_dims)
                rows = cols = np.zeros(0, np.int32)
                vals = np.zeros(0, np.float32)
            else:
                after, normfact, rows, cols, vals = out
        else:
            U = lap_matrix[prev, :]
            p = _layer_probability(U, skew, cfg.scale_factor)
            s_num = min(int((p > 0).sum()), cfg.samp_num)
            chosen = _gumbel_topk_without_replacement(rng, p, s_num)
            after = np.unique(np.concatenate([chosen, prev]))
            normfact = (1.0 / np.clip(s_num * p[after], 1e-10, 1.0)).astype(
                np.float32)
            rows, cols, vals = _slice_cols_to_coo(U, after, normfact)
        adjs.append(_pack_adj(cfg, rows, cols, vals, len(prev), len(after),
                              r_cap, c_cap, prev=prev, after=after,
                              normfact=normfact,
                              lap_indptr=lap_matrix.indptr,
                              cold_precomputed=hot_node is not None,
                              tiles_pre=tiles_pre))
        s = np.searchsorted(after, prev).astype(np.int32)
        s_pad = np.zeros(r_cap, np.int32)
        s_pad[: len(s)] = s
        sampled.append(s_pad)
        prev = after

    adjs.reverse()
    sampled.reverse()
    return _finalize_batch(cfg, caps, prev, batch_nodes, adjs, sampled,
                           labels_full)


def _finalize_batch(cfg, caps, input_nodes, batch_nodes, adjs, sampled,
                    labels_full) -> MiniBatch:
    c0 = adjs[0].ncols if adjs[0] is not None else caps[0]
    inp = np.zeros(c0, np.int32)
    inp[: len(input_nodes)] = input_nodes
    mask = np.zeros(c0, np.float32)
    mask[: len(input_nodes)] = 1.0
    b_cap = caps[-1]
    labels = np.zeros((b_cap, cfg.num_classes), np.float32)
    labels[: len(batch_nodes)] = (
        labels_full[batch_nodes].toarray().astype(np.float32))
    lmask = np.zeros(b_cap, np.float32)
    lmask[: len(batch_nodes)] = 1.0
    bn = np.zeros(b_cap, np.int32)
    bn[: len(batch_nodes)] = batch_nodes
    return MiniBatch(adjs=adjs, sampled_nodes=sampled, input_nodes=inp,
                     n_input=len(input_nodes), input_mask=mask,
                     labels=labels, label_mask=lmask, batch_nodes=bn)


def subgraph_sample(cfg: SamplerConfig, seed: int, batch_nodes: np.ndarray,
                    lap_matrix: sp.csr_matrix, labels_full: sp.csr_matrix,
                    skewed_sampling_nodes: Optional[List[np.ndarray]] = None,
                    ) -> MiniBatch:
    """Subgraph sampler (reference ``sampler.py:7-86``): one node set
    sampled from the top layer's distribution; every deeper layer is the
    square ``lap[after][:, after]`` with the same debias weights, sliced
    and packed once and shared (the same object) by all of them. The
    sample and every slice run in the native core when it loads (cold-only
    and direct-to-tiles in resident modes, as the LADIES layers)."""
    rng = np.random.default_rng(seed)
    caps = cfg.layer_caps()
    orders_td = list(cfg.orders)[::-1]
    n_layers = len(orders_td)
    prev = np.asarray(batch_nodes, dtype=np.int64)
    skew = None
    if skewed_sampling_nodes is not None and cfg.scale_factor > 1:
        # reference sampler.py:23-25 skews by the nodes resident on this
        # device; callers pass that set as a one-layer skew list
        skew = skewed_sampling_nodes[0]
    lib, ngraph = _native_graph(lap_matrix)
    hot_node = _cold_only_mask(cfg, lib)

    if lib is not None:
        from gnn_tpu_torch.native import sample_columns_native
        after, normfact, pos = sample_columns_native(
            lib, ngraph, prev, cfg.samp_num,
            int(rng.integers(2 ** 63 - 1)), skew, cfg.scale_factor)
    else:
        U = lap_matrix[prev, :]
        p = _layer_probability(U, skew, cfg.scale_factor)
        s_num = min(int((p > 0).sum()), cfg.samp_num)
        chosen = _gumbel_topk_without_replacement(rng, p, s_num)
        after = np.unique(np.concatenate([chosen, prev]))
        normfact = (1.0 / np.clip(s_num * p[after], 1e-10, 1.0)).astype(
            np.float32)
        pos = None
    cap_bottom = caps[0]

    def _slice_and_pack(row_set, r_cap):
        """Pack ``lap[row_set][:, after]``."""
        tiles_pre = None
        if lib is not None:
            from gnn_tpu_torch.native import slice_rows_native
            tile_spec, es_dims = _tile_spec(cfg, hot_node, r_cap, cap_bottom)
            out = slice_rows_native(lib, ngraph, row_set, pos, normfact,
                                    hot_node=hot_node, tile_spec=tile_spec)
            if tile_spec is not None:
                tiles_pre = (*out, *es_dims)
                rows = cols = np.zeros(0, np.int32)
                vals = np.zeros(0, np.float32)
            else:
                rows, cols, vals = out
        else:
            rows, cols, vals = _slice_cols_to_coo(
                lap_matrix[row_set, :], after, normfact)
        return _pack_adj(cfg, rows, cols, vals, len(row_set), len(after),
                         r_cap, cap_bottom, prev=row_set, after=after,
                         normfact=normfact, lap_indptr=lap_matrix.indptr,
                         cold_precomputed=hot_node is not None,
                         tiles_pre=tiles_pre)

    adjs: List[Optional[object]] = []
    sampled: List[np.ndarray] = []
    # top-down: order-0 layers keep their node set; the first aggregating
    # layer maps the batch onto the sampled set
    d = 0
    while d < n_layers:
        r_cap = caps[n_layers - d]
        d += 1
        if orders_td[d - 1] == 0:
            adjs.append(None)
            sampled.append(np.zeros(r_cap, np.int32))
            continue
        adjs.append(_slice_and_pack(prev, r_cap))
        s_pad = np.zeros(r_cap, np.int32)
        s_pad[: len(prev)] = np.searchsorted(after, prev)
        sampled.append(s_pad)
        break
    sq_adj = None
    for d in range(d, n_layers):
        r_cap = caps[n_layers - d]
        if sq_adj is None:
            sq_adj = _slice_and_pack(after, r_cap)
            sq_cap = r_cap
        # uniform caps make every deeper layer the same padded square
        assert r_cap == sq_cap, (r_cap, sq_cap)
        adjs.append(sq_adj)
        # deeper rows ARE the shared node set: sampled_nodes is the
        # identity on valid rows (pad rows point at input 0)
        s_pad = np.zeros(r_cap, np.int32)
        s_pad[: len(after)] = np.arange(len(after), dtype=np.int32)
        sampled.append(s_pad)
    adjs.reverse()
    sampled.reverse()
    return _finalize_batch(cfg, caps, after, batch_nodes, adjs, sampled,
                           labels_full)


SAMPLERS = {"ladies": ladies_sample, "subgraph": subgraph_sample}
