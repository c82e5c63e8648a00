"""The port's full-graph trainer (gnn_tpu_torch.train.fullgraph) against
the JAX package's (gnn_tpu.train.fullgraph) on the CPU.

The JAX trainer runs on 1, 2 or 4 of the eight virtual devices, the
port's on as many gloo ranks (`tests/torch_halo_worker.py`, which loads
no JAX; one rank runs in this process), from the same weights
(`gnn_tpu_torch.weights.fullgraph_params_from_jax`). Tolerances: the
forward within 1e-5 (float32 sums in another order), step losses and
parameters after three Adam steps within 1e-4; the port's runs over 1, 2
and 4 ranks agree with each other within 1e-5, and a grid context
computes bit for bit what the flat world of the same ranks computes.
"""
import numpy as np
import pytest
import torch

import torch_halo_worker as worker
from gnn_tpu_torch.parallel.dist import DistContext
from gnn_tpu_torch.train.fullgraph import FullGraphTrainer
from gnn_tpu_torch.utils.normalize import build_laplacian
from gnn_tpu_torch.weights import fullgraph_params_from_jax
from test_torch_halo import spawn

STEPS = 3
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
INVARIANT_TOL = dict(rtol=1e-5, atol=1e-6)


def _kw(g, orders=(1, 1)):
    lap = build_laplacian(g.adj_full, "gcn")
    mask = np.zeros(lap.shape[0], bool)
    mask[g.train_nodes] = True
    return dict(adj=lap, feats=g.feats,
                labels_dense=np.asarray(g.labels.todense(), np.float32),
                train_mask=mask, orders=orders, nhid=32,
                num_classes=g.num_classes, lr=0.02, sigmoid_loss=False)


def _jax_trainer(kw, ndev, params=None):
    import jax

    from gnn_tpu.train.fullgraph import FullGraphTrainer as JTrainer
    jtr = JTrainer(n_devices=ndev, **kw)
    if params is not None:
        jtr.params = jax.tree_util.tree_map(np.asarray, params)
        jtr.opt_state = jtr.optimizer.init(jtr.params)
    return jtr


def _host(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(kw, init):
    tr = FullGraphTrainer(device="cpu", **kw)
    tr.net.load_state_dict(init)
    return tr


@pytest.fixture(scope="module")
def jax_init(small_graph):
    """The JAX trainer's initial parameters (host arrays)."""
    return _host(_jax_trainer(_kw(small_graph), 1).params)


def _grads_norm(kw, init):
    tr = _port(kw, init)
    tr.local_loss().backward()
    return float(torch.sqrt(sum((p.grad ** 2).sum()
                                for p in tr.net.parameters())))


@pytest.fixture(scope="module")
def clip_init(small_graph, jax_init):
    """The initial parameters with the head kernel scaled until the whole
    gradient's norm is above 5 (the clip binds)."""
    kw = _kw(small_graph)
    for scale in (10.0, 30.0, 100.0, 300.0):
        params = {k: dict(v) for k, v in jax_init.items()}
        params["head"]["kernel"] = jax_init["head"]["kernel"] * scale
        norm = _grads_norm(kw, fullgraph_params_from_jax(params))
        if norm > 6.0:
            return params, norm
    raise AssertionError(f"no scale makes the gradient norm exceed 5: "
                         f"{norm}")


@pytest.fixture(scope="module")
def rank_runs(small_graph, jax_init, clip_init, tmp_path_factory):
    """``runs(ndev)``: ``STEPS`` steps on 2 ranks (and the clip case) or
    on 4 ranks, flat and as a 2 x 2 grid; each spawned once."""
    cache = {}

    def runs(ndev):
        if ndev not in cache:
            out = tmp_path_factory.mktemp(f"fullgraph{ndev}")
            clip = (fullgraph_params_from_jax(clip_init[0]) if ndev == 2
                    else None)
            spawn(ndev, worker.fullgraph_case,
                  (2 if ndev == 4 else 1, _kw(small_graph),
                   fullgraph_params_from_jax(jax_init), STEPS, clip), out)
            cache[ndev] = [dict(np.load(out / f"fullgraph{r}.npz"))
                           for r in range(ndev)]
        return cache[ndev]
    return runs


def _keyed(rec, prefix):
    return {k[len(prefix):]: v for k, v in rec.items()
            if k.startswith(prefix)}


def test_forward_matches_jax_predict(small_graph, jax_init):
    """One rank's predictions from the JAX initial weights against the
    JAX trainer's ``predict`` on 4 devices."""
    kw = _kw(small_graph)
    want = _jax_trainer(kw, 4, jax_init).predict()
    got = _port(kw, fullgraph_params_from_jax(jax_init)).predict()
    assert got.shape == want.shape == (small_graph.adj_full.shape[0],
                                       small_graph.num_classes)
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_weights_map_onto_the_module(jax_init):
    net_keys = set(_port_net_keys(jax_init))
    mapped = fullgraph_params_from_jax(jax_init)
    assert set(mapped) == net_keys
    np.testing.assert_array_equal(mapped["gcs.1.linear.weight"].numpy(),
                                  jax_init["gcs_1"]["kernel"].T)
    np.testing.assert_array_equal(mapped["head.bias"].numpy(),
                                  jax_init["head"]["bias"])


def _port_net_keys(jax_init):
    from gnn_tpu_torch.train.fullgraph import init_fullgraph_params
    n_feats, nhid = jax_init["gcs_0"]["kernel"].shape
    net = init_fullgraph_params(n_feats, nhid, (1, 1),
                                jax_init["head"]["kernel"].shape[1],
                                torch.Generator().manual_seed(0))
    return net.state_dict().keys()


def _jax_run(kw, ndev, init):
    jtr = _jax_trainer(kw, ndev, init)
    losses = jtr.train_steps(STEPS)
    return losses, fullgraph_params_from_jax(_host(jtr.params))


def _check_against_jax(losses, params, want_losses, want_params):
    np.testing.assert_allclose(losses, want_losses, **TRAIN_TOL)
    assert params.keys() == want_params.keys()
    for k, v in want_params.items():
        np.testing.assert_allclose(params[k], v.numpy(), **TRAIN_TOL,
                                   err_msg=k)


def test_one_rank_trains_like_jax(small_graph, jax_init):
    kw = _kw(small_graph)
    tr = _port(kw, fullgraph_params_from_jax(jax_init))
    losses = tr.train_steps(STEPS)
    params = {k: v.detach().numpy() for k, v in
              tr.net.state_dict().items()}
    _check_against_jax(losses, params, *_jax_run(kw, 1, jax_init))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("ndev", [2, 4])
def test_ranks_train_like_jax(small_graph, jax_init, rank_runs, ndev):
    """2 and 4 ranks against the JAX trainer on as many devices: the
    summed loss of every step and the final parameters; every rank holds
    bitwise the same parameters and the same predictions."""
    got = rank_runs(ndev)
    want = _jax_run(_kw(small_graph), ndev, jax_init)
    for rec in got:
        np.testing.assert_array_equal(rec["flat_losses"],
                                      got[0]["flat_losses"])
        np.testing.assert_array_equal(rec["flat_pred"], got[0]["flat_pred"])
        for k, v in _keyed(got[0], "flat_param_").items():
            np.testing.assert_array_equal(_keyed(rec, "flat_param_")[k], v)
    _check_against_jax(got[0]["flat_losses"],
                       _keyed(got[0], "flat_param_"), *want)


@pytest.mark.parametrize("ndev", [2, 4])
def test_partition_count_does_not_change_the_run(small_graph, jax_init,
                                                 rank_runs, ndev):
    """The port's losses and predictions over 1 rank equal those over 2
    and 4 ranks (the partitioning does not change the math)."""
    got = rank_runs(ndev)
    tr = _port(_kw(small_graph), fullgraph_params_from_jax(jax_init))
    losses = tr.train_steps(STEPS)
    np.testing.assert_allclose(got[0]["flat_losses"], losses,
                               **INVARIANT_TOL)
    np.testing.assert_allclose(got[0]["flat_pred"], tr.predict(),
                               rtol=1e-4, atol=1e-5)


def test_grid_context_equals_the_flat_world(rank_runs):
    """On 4 ranks, the 2 x 2 grid context partitions over its whole
    world: bit for bit the flat run."""
    for rec in rank_runs(4):
        for what in ("losses", "pred"):
            np.testing.assert_array_equal(rec[f"grid_{what}"],
                                          rec[f"flat_{what}"])
        for k, v in _keyed(rec, "flat_param_").items():
            np.testing.assert_array_equal(rec[f"grid_param_{k}"], v)


def test_gradients_are_summed_then_clipped(small_graph, clip_init,
                                           rank_runs):
    """A step in which the clip binds (the summed gradient's norm above
    5), on 2 ranks: Adam's first moment after it (0.1 x the update's
    gradient) equals the JAX step's and 0.1 x clip(g0 + g1), and misses
    the clip-then-sum 0.1 x (clip(g0) + clip(g1))."""
    got = rank_runs(2)
    params, norm = clip_init
    assert norm > 5.0
    jtr = _jax_trainer(_kw(small_graph), 2, params)
    jtr.train_steps(1)
    jmu = fullgraph_params_from_jax(_host(jtr.opt_state[0].mu))
    names = sorted(jmu)

    def flat(d):
        return np.concatenate([np.ravel(np.asarray(d[k])) for k in names])

    mu = flat(_keyed(got[0], "clip_mu_"))
    np.testing.assert_array_equal(flat(_keyed(got[1], "clip_mu_")), mu)
    g0, g1 = (flat(_keyed(r, "clip_grad_")) for r in got)

    def clip(g):
        return g * min(1.0, 5.0 / (np.linalg.norm(g) + 1e-6))

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    assert np.linalg.norm(g0 + g1) > 5.0
    assert rel(mu, flat(jmu)) < 1e-4
    assert rel(mu, 0.1 * clip(g0 + g1)) < 1e-5
    assert rel(0.1 * (clip(g0) + clip(g1)), flat(jmu)) > 1e-2


def test_forward_matches_the_dense_oracle(small_graph):
    """One layer, the port's own initial weights: the distributed forward
    on one rank equals dense numpy math (the JAX package's
    ``test_fullgraph_forward_matches_oracle``)."""
    kw = _kw(small_graph, orders=(1,))
    tr = FullGraphTrainer(device="cpu", seed=0, **kw)
    pred = tr.predict()
    p = {k: v.detach().numpy().astype(np.float64)
         for k, v in tr.net.state_dict().items()}
    h = kw["adj"].toarray() @ small_graph.feats
    out = h @ p["gcs.0.linear.weight"].T + p["gcs.0.linear.bias"]
    out = np.where(out > 0, out, np.expm1(out))
    mean = out.mean(1, keepdims=True)
    var = out.var(1, keepdims=True) + 1e-9
    out = (out - mean) * p["gcs.0.scale"] / np.sqrt(var) + p["gcs.0.offset"]
    nrm = np.sqrt((out ** 2).sum(1, keepdims=True) + 1e-24)
    out = out / np.maximum(nrm, 1e-12)
    expected = out @ p["head.weight"].T + p["head.bias"]
    np.testing.assert_allclose(pred, expected, rtol=2e-3, atol=2e-3)


def test_predict_gathers_node_order_and_one_rank_context():
    """A world of one given as a context: the same predictions as the
    trainer built without one."""
    from gnn_tpu_torch.data.synthetic import make_powerlaw_graph
    g = make_powerlaw_graph(300, 6, 8, 3, seed=2)
    kw = dict(_kw(g), nhid=8)
    a = FullGraphTrainer(device="cpu", **kw)
    b = FullGraphTrainer(dist=DistContext(), **kw)
    np.testing.assert_array_equal(a.predict(), b.predict())
    assert a.predict().shape == (300, 3)
