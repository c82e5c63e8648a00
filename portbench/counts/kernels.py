"""Bytes and float32 operations of one call of the port's edge-stream
kernels, frozen from ``chip_smoke.py`` (K1 at ``:381-387``, K3/K4 at
``:545-573``): each input byte read once and each output byte written
once, as the kernel's inputs need them. The least time a call can take
is the larger of bytes over HBM bandwidth and operations over the
float32 peak (:func:`bound_s`).

Counts (all for one sampled layer of one batch):

* ``e``: cold edges the kernel streams (2 B per packed coordinate);
* ``nb``: tile entries that hold edges (16 B per entry: its tile, offset
  and count, and its place in the transposed order);
* ``n_in`` / ``n_out``: the valid rows the call gathers from and writes;
* ``f``: the feature width of the rows;
* ``rows`` / ``cols``: the valid rows and columns whose rank-1 factors
  the call reads (4 B each);
* ``r`` / ``c`` / ``n`` / ``h``: an attention layer's valid output rows,
  input rows, width and heads.
"""
from __future__ import annotations

from portbench.counts.peaks import HBM_BYTES_PER_S, PEAK_FLOPS


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds a float32 kernel moving ``nbytes`` and doing
    ``flops`` can take on the card."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"])


def k1_call(e: int, nb: int, n_in: int, n_out: int, f: int, rows: int,
            cols: int, per_edge_values: bool = False):
    """``(bytes, flops)`` of one K1 call (edge-stream SpMM, forward or
    transpose): ``y = rv * (A @ (nf * x))`` over the cold edges."""
    nbytes = (2 * e + 16 * nb + 4 * (n_in + n_out) * f + 4 * (rows + cols)
              + (4 * e if per_edge_values else 0))
    flops = 2 * e * f + (n_in + n_out) * f
    return nbytes, flops


def k3k4_calls(e: int, nb: int, r: int, c: int, n: int, h: int) -> dict:
    """``{kernel: (bytes, flops)}`` of the four edge-stream attention
    calls of one layer's step: K3 ``rowmax`` and K4 ``terms`` forward,
    K4 ``bwd_q`` and ``bwd_kv`` backward."""
    base = 2 * e + 16 * nb
    qkv = 4 * (r * n + 2 * c * n)
    return {
        "rowmax": (base + 4 * (r * n + c * n) + 4 * r * h, 2 * e * n),
        "terms": (base + qkv + 4 * r * h + 4 * (r * h + r * n), 4 * e * n),
        "bwd_q": (base + qkv + 4 * (2 * r * h + r * n) + 4 * r * n,
                  6 * e * n),
        "bwd_kv": (base + qkv + 4 * (2 * r * h + r * n) + 4 * nb + 8 * c * n,
                   8 * e * n),
    }
