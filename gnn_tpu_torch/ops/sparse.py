"""Sparse neighborhood aggregation: the PyTorch counterpart of
`gnn_tpu.ops.sparse`.

* :class:`COOAdj` — the padded COO adjacency of one sampled layer, packed
  on the host by :func:`pack_coo` into the same arrays the JAX package
  packs (numpy), moved to the device by :func:`to_device`.
* :func:`_coo_aggregate` — ``y[r] = sum_e vals[e] * x[cols[e]]`` as a
  chunked ``index_add_`` (chunking bounds the ``[chunk, F]`` gather
  temporary, like the JAX ``lax.scan`` over ``_COO_CHUNK`` edges).
* :func:`spmm` — ``y = A @ x`` as a ``torch.autograd.Function`` whose
  backward is the transpose aggregation ``dx = A^T @ dy``; the adjacency
  gets no gradient (reference ``custom_sparse_ops.py:31-37``).

The resident hot-block adjacency (:class:`~gnn_tpu_torch.ops.hotdense.
HotDenseAdj`) dispatches to `gnn_tpu_torch.ops.hotdense`, whose cold
residual runs the hand-written edge-stream CUDA kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


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
    raise TypeError(f"unknown adjacency type {type(adj)}")


def _transpose_forward(adj, g):
    from gnn_tpu_torch.ops import hotdense as _hot
    if isinstance(adj, _hot.HotDenseAdj):
        return _hot.hot_transpose(adj, g)
    if isinstance(adj, COOAdj):
        # A^T aggregation reuses the same COO with roles swapped
        return _coo_aggregate(adj.cols, adj.rows, adj.vals, g, adj.ncols)
    raise TypeError(f"unknown adjacency type {type(adj)}")


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
