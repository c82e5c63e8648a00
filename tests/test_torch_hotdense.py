"""The port's host-packed hot format (gnn_tpu_torch.ops.hotdense:
pack_hotdense, bind_dense, hot_forward / hot_transpose) against gnn_tpu's
on one sampled layer of ``small_graph`` with a float32 hot block (K 256).

* ``pack_hotdense`` must give the JAX package's arrays: the same index
  arrays and dtypes, and the JAX package's bfloat16 values as the port's
  bfloat16-rounded float32 ones. Both packages split the layer in their
  native cores (float32 values) or in numpy/scipy (float64 values, which
  the native split does not take).
* ``spmm`` over the bound layer and its backward must match the JAX
  package's ``spmm`` / ``spmm_transpose``: rtol = atol = 1e-5 (float32
  sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.ops import hotdense as jhd
from gnn_tpu.ops.sparse import spmm as jspmm, spmm_transpose as jspmm_t
from gnn_tpu.placement.engine import compute_sample_prob
from gnn_tpu.sampling.ladies import _slice_cols_to_coo
from gnn_tpu.utils.normalize import build_laplacian
from gnn_tpu_torch.ops import hotdense as thd
from gnn_tpu_torch.ops.sparse import spmm as tspmm, to_device

TOL = dict(rtol=1e-5, atol=1e-5)


def _layer(g, seed=0):
    """One sampled layer: 64 target rows, 192 extra sampled columns, a
    LADIES-like debias vector and the row-sorted COO of
    ``lap[prev][:, after]``; the hot spec and blocks of both packages."""
    lap = build_laplacian(g.adj_full, "graphsage")
    rng = np.random.default_rng(seed)
    prev = np.sort(g.train_nodes[:64]).astype(np.int64)
    after = np.union1d(prev, rng.choice(lap.shape[0], 192, replace=False))
    normfact = (rng.random(len(after)) * 4 + 0.5).astype(np.float32)
    rows, cols, vals = _slice_cols_to_coo(lap[prev, :], after, normfact)
    prob = compute_sample_prob(lap, g.train_nodes, 2)
    jspec = jhd.HotSpec.from_sample_prob(prob, 256)
    tspec = thd.HotSpec.from_sample_prob(prob, 256)
    return lap, jspec, tspec, prev, after, normfact, rows, cols, vals


def _pack_both(g, compress, native=True):
    lap, jspec, tspec, prev, after, nf, rows, cols, vals = _layer(g)
    if not native:
        vals = vals.astype(np.float64)   # float32 values only go native
    args = (rows, cols, vals, prev, after, nf, len(prev), len(after), 128,
            384)
    j = jhd.pack_hotdense(jspec, *args, compress=compress)
    t = thd.pack_hotdense(tspec, *args, compress=compress)
    return lap, jspec, tspec, j, t


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("compress", [True, False])
def test_pack_hotdense_matches_jax(small_graph, compress, native):
    _, _, _, j, t = _pack_both(small_graph, compress, native)
    assert t.t_sorted and j.t_sorted
    assert t.dense is None and t.dense_t is None
    for f in ("nrows", "ncols", "k", "n_valid_rows", "n_valid_cols"):
        assert int(getattr(t, f)) == int(getattr(j, f)), f
    for f in ("rows", "cols", "vals", "rows_t", "cols_t", "vals_t",
              "colpos", "nfh", "rowpos", "nf_col", "present_row_slots",
              "row_cmp_idx", "present_col_slots", "col_cmp_idx"):
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        if str(b.dtype) == "bfloat16":
            b = b.astype(np.float32)
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)
    # the transpose copy is col-sorted and holds the same edges
    assert np.all(np.diff(t.cols_t.astype(np.int64)) >= 0)
    n = int(np.count_nonzero(t.vals))
    assert n == int(np.count_nonzero(t.vals_t)) > 0


@pytest.mark.parametrize("compress", [True, False])
def test_hot_forward_and_backward_match_jax(small_graph, compress):
    """``spmm`` over a bound hot layer (hot_forward) and its autograd
    backward (hot_transpose over the col-sorted copy) against the JAX
    package's ``spmm`` and ``spmm_transpose``."""
    lap, jspec, tspec, j, t = _pack_both(small_graph, compress)
    d, dt = jhd.build_hot_dense(lap, jspec, np.float32)
    td, tdt = thd.build_hot_dense(lap, tspec, torch.float32, "cpu")
    (ja,) = jhd.bind_dense([j], jnp.asarray(d), jnp.asarray(dt))
    (ta,) = thd.bind_dense([to_device(t, "cpu")], td, tdt)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(ta.ncols, 12)).astype(np.float32)
    gy = rng.normal(size=(ta.nrows, 12)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tspmm(ta, xt)
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jspmm(ja, jnp.asarray(x))), **TOL)
    (y * torch.from_numpy(gy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(jspmm_t(ja, jnp.asarray(gy))),
                               **TOL)


def test_bind_dense(small_graph):
    """bind_dense returns a new list: hot layers carry the blocks, other
    entries pass through, the shipped layer stays unbound."""
    lap, _, tspec, _, t = _pack_both(small_graph, True)
    td, tdt = thd.build_hot_dense(lap, tspec, torch.float32, "cpu")
    dev = to_device(t, "cpu")
    adjs = [None, dev, "other"]
    out = thd.bind_dense(adjs, td, tdt)
    assert out is not adjs and out[0] is None and out[2] == "other"
    assert out[1].dense is td and out[1].dense_t is tdt
    assert dev.dense is None and adjs[1] is dev
    assert out[1].rows is dev.rows
