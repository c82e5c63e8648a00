"""The hybrid DP x cache mode in the port (``hybrid_view`` of a grid
context, ``CachedFeatures(..., part=ctx.cache_part)``): every
rank a data rank with its own batch, the cache's P buffers sharded over
groups of P ranks, the gradient sum over the whole world. Held against a
host lookup, against plain data parallelism with the replicated table
and against the JAX package's ``Trainer`` on ``make_hybrid_mesh(dp=2,
part=4)`` with ``CachedFeatures(..., axis=PART_AXIS, world_size=8)``.

Port ranks are gloo processes on the CPU (`tests/torch_hybrid_worker.py`,
which loads no JAX). The gather is exact; the 2 x 2 epoch through the
cache is bit for bit the 4-rank epoch with the replicated table; the
2 x 4 epoch agrees with the JAX mesh within 1e-5 (float32 sums in
another order, over Adam steps), with both pipelines at one native
sampler width (the same ``pool_num``, ROADMAP §3).
"""
import dataclasses

import numpy as np
import pytest

import torch_dist_worker as dw
import torch_hybrid_worker as worker
from test_torch_halo import spawn

TRAIN_TOL = dict(rtol=1e-5, atol=1e-5)
PER_DEV = 300


def _placement(g, parts):
    """Both packages' greedy placements of ``PER_DEV`` nodes a buffer over
    ``parts`` buffers (equal), alpha 0 (the CLI's default: the buffers
    differ, so ranks read rows from their group); returns (jax, port)."""
    from gnn_tpu.placement import engine as jeng
    from gnn_tpu_torch.placement import engine as teng
    from gnn_tpu_torch.utils.normalize import build_laplacian
    lap = build_laplacian(g.adj_full, "graphsage")
    out = [eng.greedy_placement(eng.compute_sample_prob(lap, g.train_nodes,
                                                        2),
                                per_dev=PER_DEV, num_devs=parts, alpha=0.0)
           for eng in (jeng, teng)]
    np.testing.assert_array_equal(out[1].device_id_of_nodes,
                                  out[0].device_id_of_nodes)
    np.testing.assert_array_equal(out[1].idx_of_nodes_on_device,
                                  out[0].idx_of_nodes_on_device)
    return out


def _jax_hybrid_trainer(g, monkeypatch, dp, parts, placement):
    """The JAX Trainer on a ``(dp, parts)`` hybrid mesh at the workers'
    configuration, the cache sharded over ``part``, every step's mean
    loss recorded in ``jtr.step_losses`` (the mesh of ``make_hybrid_mesh``
    on the first ``dp * parts`` virtual devices)."""
    import jax
    from jax.sharding import Mesh

    from gnn_tpu.models.gnn import build_model as jbuild
    from gnn_tpu.ops.hotdense import HotSpec, build_hot_dense
    from gnn_tpu.ops.residentgraph import build_resident_graph
    from gnn_tpu.parallel.feature_cache import CachedFeatures
    from gnn_tpu.parallel.multihost import DATA_AXIS, PART_AXIS
    from gnn_tpu.placement.engine import compute_sample_prob
    from gnn_tpu.sampling.ladies import SamplerConfig
    from gnn_tpu.sampling.pipeline import BatchPipeline
    from gnn_tpu.train.trainer import Trainer
    from gnn_tpu.utils.normalize import build_laplacian

    monkeypatch.setenv("GNN_TPU_PACKED", "0")
    lap = build_laplacian(g.adj_full, "graphsage")
    spec = HotSpec.from_sample_prob(
        compute_sample_prob(lap, g.train_nodes, 2), dw.HOT_K)
    d, dt = build_hot_dense(lap, spec, np.float32)
    cfg = SamplerConfig(num_nodes=lap.shape[0], num_classes=g.num_classes,
                        adj_format="resident", hot_spec=spec,
                        resident_val_free=True, resident_stream_tiles=True,
                        **dw.SAMPLER)
    ws = dp * parts
    pipe = BatchPipeline(cfg, lap, g.labels, world_size=ws,
                         pool_num=dw.POOL, seed=dw.SEED)
    jtr = Trainer(jbuild("graphsage", dw.NHID, dw.SAMPLER["orders"],
                         g.num_classes, dropout=0.0), pipe, g.feats,
                  mesh=Mesh(np.asarray(jax.devices()[:ws]).reshape(dp, parts),
                            (DATA_AXIS, PART_AXIS)), lr=0.01,
                  sigmoid_loss=True, seed=dw.SEED,
                  feature_source=CachedFeatures(g.feats, placement,
                                                axis=PART_AXIS,
                                                world_size=ws),
                  resident_graph=build_resident_graph(lap, spec, d, dt))
    jtr.step_losses = []
    step = jtr.fns.train_step

    def recorded(*a):
        params, opt_state, loss = step(*a)
        jtr.step_losses.append(float(loss))
        return params, opt_state, loss
    jtr.fns = dataclasses.replace(jtr.fns, train_step=recorded)
    return jtr


def _jax_epoch(g, dp, parts, placement, targets):
    """The port's initial weights (from the JAX init) and the JAX mesh's
    epoch: step losses and final parameters."""
    import jax

    from gnn_tpu_torch.weights import params_from_flax
    from test_torch_dist import _init
    mp = pytest.MonkeyPatch()
    try:
        jtr = _jax_hybrid_trainer(g, mp, dp, parts, placement)
        init = _init(jtr, targets)
        jtr.train_epoch(targets, 0)
        host = jax.tree_util.tree_map(np.asarray, jtr.params)
        jtr.close()
    finally:
        mp.undo()
    return init, dict(losses=jtr.step_losses, params=params_from_flax(host))


@pytest.fixture(scope="module")
def runs(small_graph, tmp_path_factory):
    """``get(parts)``: the port's 2 x ``parts`` ranks (the 2 x 2 run
    through the cache and the replicated table, the 2 x 4 run through
    the cache) and, for 2 x 4, the JAX mesh's epoch; each run once."""
    cache = {}

    def get(parts):
        if parts not in cache:
            ws = 2 * parts
            targets = small_graph.train_nodes[:ws * 2 * dw.SAMPLER[
                "batch_size"]]
            jpl, tpl = _placement(small_graph, parts)
            init, want = _jax_epoch(small_graph, 2, parts, jpl, targets)
            sources = ("cached", "replicated") if parts == 2 else \
                ("cached",)
            out = tmp_path_factory.mktemp(f"hybrid{parts}")
            spawn(ws, worker.hybrid_case,
                  (parts, tpl, init, targets, sources), out)
            cache[parts] = (want, [dict(np.load(out / f"hybrid{r}.npz"))
                                   for r in range(ws)])
        return cache[parts]
    return get


@pytest.mark.parametrize("parts", [2, 4])
def test_hybrid_gather_matches_the_host(small_graph, runs, parts):
    """Every rank's gather of its first batch through the part group's
    exchange equals ``feats[input_nodes] * mask`` exactly; rows came
    from the rank's own buffer, its group's other buffers and the host."""
    _, got = runs(parts)
    for rec in got:
        want = (small_graph.feats[rec["input_nodes"]]
                * rec["input_mask"][:, None])
        np.testing.assert_array_equal(rec["gather"], want)
        local, peer, host = rec["stats"]
        assert local + peer + host == int(rec["input_mask"].sum())
        assert local > 0 and peer > 0 and host > 0


def test_hybrid_epoch_equals_replicated_dp(runs):
    """On 2 x 2 ranks, one epoch through the hybrid cache is bit for bit
    the epoch of four data ranks with the replicated table, and every
    rank holds the same parameters."""
    _, got = runs(2)
    for rec in got:
        np.testing.assert_array_equal(rec["cached_losses"],
                                      got[0]["replicated_losses"])
        assert str(rec["cached_digest"]) == str(got[0]["replicated_digest"])
        assert str(rec["replicated_digest"]) == str(
            got[0]["replicated_digest"])


@pytest.mark.parametrize("parts", [2, 4])
def test_hybrid_training_matches_jax(runs, parts):
    """One epoch (two steps a rank) on 2 x ``parts`` ranks against the JAX
    Trainer on the ``(2, parts)`` hybrid mesh: every step's mean loss
    and the final parameters."""
    want, got = runs(parts)
    assert len(want["losses"]) == 2
    np.testing.assert_allclose(got[0]["cached_losses"], want["losses"],
                               **TRAIN_TOL)
    for k, v in want["params"].items():
        np.testing.assert_allclose(got[0][f"cached_param_{k}"], v.numpy(),
                                   **TRAIN_TOL, err_msg=k)
