"""(A copy of `gnn_tpu.utils.normalize`, so the port imports nothing of the JAX
package.) Graph normalization helpers (reference `utils.py:41-64`)."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def row_normalize(mx: sp.spmatrix) -> sp.csr_matrix:
    """D^-1 A (reference `utils.py:56-64`). Zero-degree rows stay zero."""
    mx = sp.csr_matrix(mx, dtype=np.float32)
    rowsum = np.asarray(mx.sum(axis=1)).flatten()
    inv = np.divide(1.0, rowsum, out=np.zeros_like(rowsum),
                    where=rowsum != 0)
    return sp.diags(inv).dot(mx).tocsr().astype(np.float32)


def sym_normalize(mx: sp.spmatrix) -> sp.csr_matrix:
    """D_r^-1/2 A D_c^-1/2 (reference `utils.py:41-54`)."""
    mx = sp.csr_matrix(mx, dtype=np.float32)
    rowsum = np.asarray(mx.sum(axis=1)).flatten()
    r = np.divide(1.0, np.sqrt(rowsum), out=np.zeros_like(rowsum),
                  where=rowsum > 0)
    colsum = np.asarray(mx.sum(axis=0)).flatten()
    c = np.divide(1.0, np.sqrt(colsum), out=np.zeros_like(colsum),
                  where=colsum > 0)
    return sp.diags(r).dot(mx).dot(sp.diags(c)).tocsr().astype(np.float32)


def build_laplacian(adj_full: sp.spmatrix, model: str,
                    norm: str = "row") -> sp.csr_matrix:
    """The propagation matrix the trainer uses (reference `main.py:267-270`):
    GraphSAGE normalizes A; GCN normalizes A + I.

    ``norm='row'`` (default) is the reference's D^-1 A; ``norm='sym'``
    is D^-1/2 A D^-1/2 (the Kipf-GCN form — the reference carries
    `sym_normalize` but never calls it, `utils.py:41-54`). Both are
    rank-1-factorizable on binary adjacencies, so both get the val-free
    resident payload and the edge-stream cold kernel."""
    if model == "gcn":
        adj_full = adj_full + sp.eye(adj_full.shape[0], dtype=np.float32)
    if norm == "sym":
        return sym_normalize(adj_full)
    assert norm == "row", norm
    return row_normalize(adj_full)
