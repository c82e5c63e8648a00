"""LADIES layer-wise importance sampling (host side): the counterpart of
`gnn_tpu.sampling.ladies`, drawing the same random numbers.

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
pattern-only transport) and ``resident``. ``hot`` and the subgraph
sampler are not ported yet (ROADMAP queue 1).
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
    adj_format: str = "coo"   # 'coo' | 'blocked' | 'pattern' | 'resident'
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
    if cfg.adj_format == "coo":
        nnz_pad = bucket_size(max(len(rows), 1))
        return sparse_ops.pack_coo(rows, cols, vals, n_rows, n_cols,
                                   r_cap, c_cap, nnz_pad,
                                   compress=cfg.compress)
    raise NotImplementedError(
        f"adj_format {cfg.adj_format!r} is not ported yet (ROADMAP queue "
        f"1: format leftovers and the subgraph sampler)")


def _layer_probability(U: sp.csr_matrix, skew_nodes, scale_factor):
    """Column sampling probability = col nnz counts, optionally skewed."""
    pi = np.bincount(U.indices, minlength=U.shape[1]).astype(np.float64)
    if scale_factor > 1 and skew_nodes is not None:
        pi[skew_nodes] = pi[skew_nodes] * scale_factor
    return pi / pi.sum()


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
    # resident-lite: the native slice emits ONLY cold edges
    hot_node = None
    if (lib is not None and cfg.adj_format == "resident"
            and cfg.resident_ship_cold and cfg.hot_spec is not None):
        # cached on the (frozen) HotSpec so the same array rides every
        # call — NativeCSR.ensure_split keys its split copy on it
        hot_node = getattr(cfg.hot_spec, "_hot_mask", None)
        if hot_node is None:
            hot_node = (cfg.hot_spec.slot_of_node >= 0).astype(np.uint8)
            object.__setattr__(cfg.hot_spec, "_hot_mask", hot_node)

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
            tile_spec = None
            if (hot_node is not None and cfg.resident_stream_tiles
                    and cfg.resident_val_free):
                # direct-to-tiles: the cold slice emits packed coords
                from gnn_tpu_torch.ops.edgestream import tile_dims
                es_bm, es_bk = tile_dims(r_cap, c_cap)
                tile_spec = (r_cap // es_bm, c_cap // es_bk,
                             es_bm.bit_length() - 1,
                             es_bk.bit_length() - 1)
            out = ladies_layer_native(
                lib, ngraph, prev, cfg.samp_num,
                int(rng.integers(2 ** 63 - 1)), skew, cfg.scale_factor,
                hot_node=hot_node, tile_spec=tile_spec)
            if tile_spec is not None:
                after, normfact, coords, tile_cnt = out
                tiles_pre = (coords, tile_cnt, es_bm, es_bk)
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


def _subgraph_sample(*args, **kwargs):
    raise NotImplementedError(
        "the subgraph sampler is not ported yet (ROADMAP queue 1: "
        "format leftovers and the subgraph sampler)")


SAMPLERS = {"ladies": ladies_sample, "subgraph": _subgraph_sample}
