"""Bytes and float32 operations of one call of the port's additive
edge-stream attention kernels (``edge_attention_additive_kernel``, the
score source of the published GAT), in the convention of
`portbench.counts.kernels`: each input read once and each output written
once, coordinates at 2 B an edge and 16 B a tile entry. The least time a
call can take is `portbench.counts.kernels.bound_s` of these.

Counts, for one sampled layer of one batch: ``e`` cold edges streamed,
``nb`` tile entries holding edges, ``r`` / ``c`` the valid output rows
and input columns, ``n`` the layer's width (heads times features) and
``h`` its heads. Every call reads ``el [r, h]``, ``er [c, h]`` and the
rows' self columns (4 B a row). Operations: ``2 n`` an edge for each
weighted sum or dot product over the width, and per edge and head 3 for
a score (add, LeakyReLU, max), 5 with the exponential and the
denominator, 8 in the backward passes.
"""
from __future__ import annotations


def additive_calls(e: int, nb: int, r: int, c: int, n: int, h: int
                   ) -> dict:
    """``{kernel: (bytes, flops)}`` of the four additive calls of one
    layer's step: ``add_rowmax`` and ``add_terms`` forward,
    ``add_bwd_q`` and ``add_bwd_kv`` backward."""
    base = 2 * e + 16 * nb + 4 * (r * h + c * h) + 4 * r
    v = 4 * c * n
    return {
        "add_rowmax": (base + 4 * r * h, 3 * e * h),
        "add_terms": (base + v + 4 * r * h + 4 * (r * h + r * n),
                      2 * e * n + 5 * e * h),
        "add_bwd_q": (base + v + 4 * (2 * r * h + r * n) + 4 * r * h,
                      2 * e * n + 8 * e * h),
        "add_bwd_kv": (base + v + 4 * (2 * r * h + r * n) + 4 * nb
                       + 4 * (c * h + c * n), 4 * e * n + 8 * e * h),
    }
