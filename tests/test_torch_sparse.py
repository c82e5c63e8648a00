"""The port's COO spmm (gnn_tpu_torch.ops.sparse) against
gnn_tpu.ops.sparse: the forward and the gradient through
``torch.autograd`` against ``jax.vjp``, on the same packed COO.
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
