"""The port's sparse layouts and spmm (gnn_tpu_torch.ops.sparse) against
gnn_tpu.ops.sparse: COO and blocked packing, the forward and the gradient
through ``torch.autograd`` against ``jax.vjp`` on the same packed arrays,
the pattern transport's packing and row expansion, and ``to_dense``.
Tolerance: rtol = atol = 1e-5 (float32 sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gnn_tpu.ops import sparse as jsp
from gnn_tpu_torch.ops import sparse as tsp

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("nr,nc,f,dens", [(96, 128, 16, 0.1),
                                          (300, 200, 7, 0.05)])
def test_coo_spmm_and_vjp_match_jax(nr, nc, f, dens, compress):
    rng = np.random.RandomState(0)
    m = sp.random(nr, nc, density=dens, format="csr", random_state=rng,
                  dtype=np.float32).tocoo()
    args = (m.row.astype(np.int32), m.col.astype(np.int32),
            m.data.astype(np.float32), nr - 3, nc - 5, nr, nc)
    ja = jsp.pack_coo(*args, compress=compress)
    ta = tsp.pack_coo(*args, compress=compress)
    np.testing.assert_array_equal(ta.rows, np.asarray(ja.rows))
    np.testing.assert_array_equal(ta.cols, np.asarray(ja.cols))
    np.testing.assert_array_equal(ta.vals,
                                  np.asarray(ja.vals).astype(np.float32))
    assert ta.rows_sorted == ja.rows_sorted
    x = rng.randn(nc, f).astype(np.float32)
    g = rng.randn(nr, f).astype(np.float32)

    jadj = jax.tree_util.tree_map(jnp.asarray, ja)
    y_j, vjp = jax.vjp(lambda xx: jsp.spmm(jadj, xx), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))

    tadj = tsp.to_device(ta, "cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = tsp.spmm(tadj, xt)
    y_t.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **TOL)
    np.testing.assert_allclose(
        tsp.spmm_transpose(tadj, torch.from_numpy(g)).numpy(),
        np.asarray(jsp.spmm_transpose(jadj, jnp.asarray(g))), **TOL)


def test_coo_aggregate_chunks(monkeypatch):
    """Chunked index_add_ equals the one-pass sum."""
    rng = np.random.RandomState(1)
    rows = torch.from_numpy(rng.randint(0, 50, 1000))
    cols = torch.from_numpy(rng.randint(0, 40, 1000))
    vals = torch.from_numpy(rng.rand(1000).astype(np.float32))
    x = torch.from_numpy(rng.randn(40, 6).astype(np.float32))
    full = tsp._coo_aggregate(rows, cols, vals, x, 50)
    monkeypatch.setattr(tsp, "_COO_CHUNK", 97)
    chunked = tsp._coo_aggregate(rows, cols, vals, x, 50)
    torch.testing.assert_close(chunked, full, **TOL)


def _coo_layer(seed, nr, nc, dens, n_valid_rows):
    rng = np.random.RandomState(seed)
    m = sp.random(n_valid_rows, nc, density=dens, format="csr",
                  random_state=rng, dtype=np.float32).tocoo()
    return rng, m.row.astype(np.int32), m.col.astype(np.int32), \
        m.data.astype(np.float32)


@pytest.mark.parametrize("nr,nc,bm,bk,max_blk", [(256, 384, 128, 128, None),
                                                 (256, 384, 128, 128, 5),
                                                 (64, 256, 8, 128, None)])
def test_blocked_spmm_and_vjp_match_jax(nr, nc, bm, bk, max_blk):
    """``BlockedAdj`` packing (arrays equal), ``spmm`` forward, its
    gradient (over the packed transposed tiles) and ``spmm_transpose``
    against the JAX package on the same packed arrays; the last row tile
    is empty and ``max_blk`` 5 adds padding tiles."""
    rng, rows, cols, vals = _coo_layer(2, nr, nc, 0.03, nr - bm)
    args = (rows, cols, vals, nr - bm, nc - 7, nr, nc)
    ja = jsp.pack_blocked(*args, bm=bm, bk=bk, max_blk=max_blk)
    ta = tsp.pack_blocked(*args, bm=bm, bk=bk, max_blk=max_blk)
    for f in ("block_cols", "block_vals", "block_cols_t", "block_vals_t"):
        np.testing.assert_array_equal(getattr(ta, f),
                                      np.asarray(getattr(ja, f)), err_msg=f)
    assert (ta.nrows, ta.ncols, ta.bm, ta.bk) == (ja.nrows, ja.ncols,
                                                  ja.bm, ja.bk)
    x = rng.randn(nc, 24).astype(np.float32)
    g = rng.randn(nr, 24).astype(np.float32)
    jadj = jax.tree_util.tree_map(jnp.asarray, ja)
    y_j, vjp = jax.vjp(lambda xx: jsp.spmm(jadj, xx), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    tadj = tsp.to_device(ta, "cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = tsp.spmm(tadj, xt)
    y_t.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **TOL)
    np.testing.assert_allclose(
        tsp.spmm_transpose(tadj, torch.from_numpy(g)).numpy(),
        np.asarray(jsp.spmm_transpose(jadj, jnp.asarray(g))), **TOL)


@pytest.mark.parametrize("compress", [True, False])
def test_pattern_pack_and_expand_match_jax(compress):
    """``pack_pattern`` arrays and ``PatternAdj.expand`` (rows rebuilt from
    per-row counts, rows without edges included; pad edges at the last
    row, not live) equal the JAX package's."""
    _, rows, cols, _ = _coo_layer(3, 200, 300, 0.02, 150)
    args = (rows, cols, 150, 290, 256, 384)
    ja = jsp.pack_pattern(*args, nnz_pad=len(rows) + 77, compress=compress)
    ta = tsp.pack_pattern(*args, nnz_pad=len(rows) + 77, compress=compress)
    np.testing.assert_array_equal(ta.cols, np.asarray(ja.cols))
    assert ta.cols.dtype == np.asarray(ja.cols).dtype
    np.testing.assert_array_equal(ta.row_cnt, np.asarray(ja.row_cnt))
    assert ta.n_edges == int(ja.n_edges) == len(rows)
    jr, jc, jl = jax.tree_util.tree_map(
        np.asarray, jax.tree_util.tree_map(jnp.asarray, ja).expand())
    tr, tc, tl = tsp.to_device(ta, "cpu").expand()
    np.testing.assert_array_equal(tr.numpy(), jr)
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tr.numpy()[:len(rows)], rows)


def test_to_dense_matches_jax_on_every_format(small_graph):
    """``to_dense`` of a COO, a blocked and a hot-block layer (its cold
    residual as COO) equals the JAX package's; the blocked and COO
    layers of one edge set give the same matrix, and so do the hot-block
    layers of one batch with the cold residual as COO or as stream
    tiles."""
    from tests.test_torch_gat import _layers

    _, rows, cols, vals = _coo_layer(4, 256, 384, 0.03, 250)
    args = (rows, cols, vals, 250, 380, 256, 384)
    coo, blk = tsp.pack_coo(*args), tsp.pack_blocked(*args)
    d_coo = tsp.to_dense(tsp.to_device(coo, "cpu")).numpy()
    d_blk = tsp.to_dense(tsp.to_device(blk, "cpu")).numpy()
    np.testing.assert_array_equal(d_coo, np.asarray(jsp.to_dense(
        jax.tree_util.tree_map(jnp.asarray, jsp.pack_coo(*args)))))
    np.testing.assert_array_equal(d_blk, np.asarray(jsp.to_dense(
        jax.tree_util.tree_map(jnp.asarray, jsp.pack_blocked(*args)))))
    np.testing.assert_array_equal(d_blk, d_coo)

    # a hot-block layer: the JAX package rebuilds it from the resident
    # graph; the port from its own, on the same sampled batch
    ja, ta, _, _ = _layers(small_graph, False)
    np.testing.assert_allclose(tsp.to_dense(ta).numpy(),
                               np.asarray(jsp.to_dense(ja)), **TOL)
    _, ta_stream, _, _ = _layers(small_graph, True)
    np.testing.assert_allclose(tsp.to_dense(ta_stream).numpy(),
                               tsp.to_dense(ta).numpy(), **TOL)
