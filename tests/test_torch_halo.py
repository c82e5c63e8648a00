"""The port's halo exchange (gnn_tpu_torch.parallel.halo) against the JAX
package's (gnn_tpu.parallel.halo).

The host plan and the partitioned features are numpy copies and must be
bit-equal to the JAX arrays. ``distributed_spmm`` runs on gloo ranks on
the CPU (`tests/torch_halo_worker.py`, which loads no JAX) and must
equal ``adj @ feats`` and the JAX ``make_distributed_spmm`` on the
virtual devices within 1e-5 (float32 sums in another order), with the
padding rows zero; its backward (the exchange's all-to-all of the
cotangents) must equal the dense product's gradient ``adj^T @ cot``.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import torch_halo_worker as worker
from gnn_tpu_torch.parallel import dist as tdist
from gnn_tpu_torch.parallel import halo as thalo

TOL = dict(rtol=1e-5, atol=1e-5)
N, F = 600, 24


def _graph(seed=0, n=N, density=0.02):
    rng = np.random.RandomState(seed)
    adj = sp.random(n, n, density=density, format="csr", random_state=rng,
                    dtype=np.float32)
    return adj, rng.randn(n, F).astype(np.float32), \
        rng.randn(n, F).astype(np.float32)


def spawn(n, fn, args, out_dir):
    saved = tdist.JOIN_TIMEOUT_S, tdist.COLLECTIVE_TIMEOUT_S
    tdist.JOIN_TIMEOUT_S, tdist.COLLECTIVE_TIMEOUT_S = 300.0, 120.0
    try:
        tdist.spawn_ranks(n, fn, (str(out_dir),) + tuple(args),
                          rendezvous_dir=str(out_dir))
    finally:
        tdist.JOIN_TIMEOUT_S, tdist.COLLECTIVE_TIMEOUT_S = saved


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_plan_and_partition_bit_equal_to_jax(ndev):
    from gnn_tpu.parallel import halo as jhalo
    adj, feats, _ = _graph()
    jplan, jowner = jhalo.build_halo_plan(adj, ndev)
    tplan, towner = thalo.build_halo_plan(adj, ndev)
    np.testing.assert_array_equal(towner, jowner)
    assert (tplan.n_local, tplan.halo_width) == (jplan.n_local,
                                                 jplan.halo_width)
    assert tplan.num_devs == ndev
    for f in ("intra_rows", "intra_cols", "intra_vals", "halo_rows",
              "halo_cols", "halo_vals", "send_idx", "send_mask"):
        j, t = np.asarray(getattr(jplan, f)), getattr(tplan, f)
        assert t.dtype == j.dtype, f
        np.testing.assert_array_equal(t, j, err_msg=f)
    np.testing.assert_array_equal(
        thalo.partition_features(feats, towner, ndev, tplan.n_local),
        jhalo.partition_features(feats, jowner, ndev, jplan.n_local))


def _jax_spmm(adj, feats, ndev):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gnn_tpu.parallel import halo as jhalo
    from gnn_tpu.parallel.mesh import DATA_AXIS, make_mesh
    plan, owner = jhalo.build_halo_plan(adj, ndev)
    mesh = make_mesh(ndev)
    sh = NamedSharding(mesh, P(DATA_AXIS))
    plan_dev = jax.tree_util.tree_map(
        lambda a: jax.device_put(jnp.asarray(a), sh)
        if hasattr(a, "ndim") else a, plan)
    x = jhalo.partition_features(feats, owner, ndev, plan.n_local)
    return np.asarray(jhalo.make_distributed_spmm(mesh, plan)(
        plan_dev, jax.device_put(jnp.asarray(x), sh)))


@pytest.fixture(scope="module", params=[2, 4])
def spmm_runs(request, tmp_path_factory):
    ndev = request.param
    adj, feats, cot = _graph()
    out = tmp_path_factory.mktemp(f"spmm{ndev}")
    spawn(ndev, worker.spmm_case, (adj, feats, cot), out)
    return ndev, [dict(np.load(out / f"spmm{r}.npz")) for r in range(ndev)]


def test_distributed_spmm_matches_dense_and_jax(spmm_runs):
    """Each rank's rows equal ``adj @ feats`` and the JAX mesh's output;
    the padding rows are zero."""
    ndev, got = spmm_runs
    adj, feats, _ = _graph()
    plan, owner = thalo.build_halo_plan(adj, ndev)
    want = adj @ feats
    jy = _jax_spmm(adj, feats, ndev)
    for d in range(ndev):
        mine = np.flatnonzero(owner == d)
        y = got[d]["y"]
        assert y.shape == (plan.n_local, F)
        np.testing.assert_allclose(y[: len(mine)], want[mine], **TOL)
        np.testing.assert_allclose(y, jy[d], **TOL)
        assert not y[len(mine):].any()


def test_exchange_backward_is_the_transposed_product(spmm_runs):
    """The gradient of ``sum(y * cot)`` on each rank's partition equals
    the dense product's on one rank, ``adj^T @ cot``: the cotangents of
    the received rows went back to their owners."""
    ndev, got = spmm_runs
    adj, feats, cot = _graph()
    x = torch.from_numpy(feats).requires_grad_(True)
    dense = torch.from_numpy(adj.toarray())
    ((dense @ x) * torch.from_numpy(cot)).sum().backward()
    want = x.grad.numpy()
    plan, owner = thalo.build_halo_plan(adj, ndev)
    for d in range(ndev):
        mine = np.flatnonzero(owner == d)
        g = got[d]["grad"]
        np.testing.assert_allclose(g[: len(mine)], want[mine], **TOL)
        assert not g[len(mine):].any()


def test_world_of_one_is_the_intra_product():
    """One rank exchanges nothing: ``A_intra @ x`` is ``adj @ feats``,
    and its backward ``adj^T @ cot``."""
    adj, feats, cot = _graph(seed=1)
    plan, owner = thalo.build_halo_plan(adj, 1)
    local = thalo.LocalHaloPlan.from_plan(plan, 0, "cpu")
    x = torch.zeros((plan.n_local, F))
    x[:N] = torch.from_numpy(feats)
    x.requires_grad_(True)
    y = thalo.distributed_spmm(local, x, tdist.DistContext())
    np.testing.assert_allclose(y.detach().numpy()[:N], adj @ feats, **TOL)
    c = torch.zeros_like(x)
    c[:N] = torch.from_numpy(cot)
    (y * c).sum().backward()
    np.testing.assert_allclose(x.grad.numpy()[:N], adj.T @ cot, **TOL)
    with pytest.raises(ValueError, match="over 1 ranks on a world of 2"):
        thalo.halo_spmm_local(local, x, tdist.DistContext(world_size=2))


@pytest.mark.cuda
def test_cuda_two_ranks_share_the_card(tmp_path):
    """Two gloo ranks on ``cuda:0``: the exchange of CUDA tensors, the
    product and its backward against the dense math within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    adj, feats, cot = _graph()
    spawn(2, worker.spmm_case, (adj, feats, cot, "cuda"), tmp_path)
    plan, owner = thalo.build_halo_plan(adj, 2)
    for d in range(2):
        got = dict(np.load(tmp_path / f"spmm{d}.npz"))
        mine = np.flatnonzero(owner == d)
        np.testing.assert_allclose(got["y"][: len(mine)],
                                   (adj @ feats)[mine], **TOL)
        np.testing.assert_allclose(got["grad"][: len(mine)],
                                   (adj.T @ cot)[mine], **TOL)
