"""Data parallelism in the port (gnn_tpu_torch.parallel.dist, the
rank-aware pipeline, CachedFeatures, the clip-then-sum step, the CLI's
``--n_devices``) against the JAX package's 2-device mesh on the CPU.

Port ranks are gloo processes on the CPU, started with
``spawn_ranks`` from `tests/torch_dist_worker.py` (which loads no JAX);
the JAX package runs on two of the eight virtual CPU devices. Batches
are compared bit for bit before the JAX pipeline re-pads them (both
pipelines with the same pool size, so the native sampler runs at the
same OpenMP width); feature gathers exactly; training at rtol 1e-4 /
atol 1e-5 (float32 sums in another order, over Adam steps), dropout off
and the same initial weights. This module imports JAX only inside its
tests, so ``pytest --noconftest -m cuda`` runs its card test where JAX is
absent."""
import contextlib
import dataclasses
import json
import math
import os
import types

import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from gnn_tpu_torch.parallel import dist as tdist

TINY = ["--dataset", "synthetic:nodes=1200,deg=10,feats=16,classes=5",
        "--nhid", "16", "--orders", "1,1", "--samp_num", "128",
        "--batch_size", "64", "--epoch_num", "1", "--hot_k", "256",
        "--pool_num", "2"]
# the fixed locality factor of the skewed cases
SKEW_FACTOR = 4.0


@contextlib.contextmanager
def short_timeouts():
    """Spawned ranks fail within minutes, not the defaults' hours."""
    saved = tdist.JOIN_TIMEOUT_S, tdist.COLLECTIVE_TIMEOUT_S
    tdist.JOIN_TIMEOUT_S, tdist.COLLECTIVE_TIMEOUT_S = 300.0, 120.0
    try:
        yield
    finally:
        tdist.JOIN_TIMEOUT_S, tdist.COLLECTIVE_TIMEOUT_S = saved


def spawn(fn, args, out_dir):
    with short_timeouts():
        tdist.spawn_ranks(worker.WORLD, fn, (str(out_dir),) + tuple(args),
                          rendezvous_dir=str(out_dir))


# --- the pipeline: rank r's batches are the JAX pipeline's for rank r ---

def _placements(graph, lap, strategy="greedy"):
    """Both packages' placements of 20% of the nodes over two ranks (alpha
    0, the CLI's default: the ranks' buffers differ)."""
    from gnn_tpu.placement import engine as jeng
    from gnn_tpu_torch.placement import engine as teng
    n = lap.shape[0]
    out = [eng.create_placement(lap, graph.train_nodes, per_dev=n // 5,
                                num_devs=2, num_conv_layers=2, alpha=0.0,
                                strategy=strategy) for eng in (jeng, teng)]
    np.testing.assert_array_equal(out[1].device_id_of_nodes,
                                  out[0].device_id_of_nodes)
    np.testing.assert_array_equal(out[1].idx_of_nodes_on_device,
                                  out[0].idx_of_nodes_on_device)
    return out


def _skews(graph, lap):
    """Both packages' per-rank skew sets of the greedy placement."""
    import scipy.sparse as sp

    from gnn_tpu.placement import engine as jeng
    from gnn_tpu_torch.placement import engine as teng
    n = lap.shape[0]
    out = [eng.get_per_rank_skewed_nodes(graph.adj_full + sp.eye(n), pl,
                                         (1, 1))
           for eng, pl in zip((jeng, teng), _placements(graph, lap))]
    for js, ts in zip(out[0], out[1]):
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(b, a)
    return out


def _pipelines(graph, case, pool_num=2):
    """The JAX pipeline at world size 2 and the port's two ranks for one
    of the batch cases; returns (jax, [port rank 0, rank 1], targets,
    jax rank chunks, port rank chunks)."""
    from gnn_tpu.sampling import pipeline as jpl
    from gnn_tpu_torch.sampling import pipeline as tpl
    from tests.test_torch_sampler import _cfgs

    lap, jcfg, tcfg = _cfgs(graph, "resident", True)
    targets = graph.train_nodes[:256]
    local = case in ("local_shuffle", "pagraph")
    jskew = tskew = jchunks = tchunks = None
    if case == "pagraph":
        jpl_, tpl_ = _placements(graph, lap, "pagraph")
        jchunks = jpl_.train_nodes_per_dev
        tchunks = tpl_.train_nodes_per_dev
        for a, b in zip(jchunks, tchunks):
            np.testing.assert_array_equal(b, a)
        # uneven chunks (4 and 2 steps of 64): rank 1 cycles through its
        # chunk at steps 2 and 3
        jchunks = [jchunks[0][:200], jchunks[1][:100]]
        tchunks = [tchunks[0][:200], tchunks[1][:100]]
        assert min(len(c) for c in jchunks) == 100
    if case == "uneven_skew":
        # 257 targets: chunks of 129 and 128, so rank 1 runs out after two
        # steps of 64 and cycles through its chunk at the third
        targets = graph.train_nodes[:257]
        jskew, tskew = _skews(graph, lap)
        jcfg = dataclasses.replace(jcfg, scale_factor=SKEW_FACTOR)
        tcfg = dataclasses.replace(tcfg, scale_factor=SKEW_FACTOR)
    jp = jpl.BatchPipeline(jcfg, lap, graph.labels, world_size=2,
                           pool_num=pool_num, per_rank_skew=jskew,
                           local_shuffle=local, seed=3)
    tps = [tpl.BatchPipeline(tcfg, lap, graph.labels, pool_num=pool_num,
                             per_rank_skew=tskew, local_shuffle=local,
                             seed=3, world_size=2, rank=r)
           for r in range(2)]
    return jp, tps, targets, jchunks, tchunks


@pytest.mark.parametrize("case", ["global", "local_shuffle", "pagraph",
                                  "uneven_skew"])
def test_rank_batches_match_jax(small_graph, case):
    """Two epochs (the second primed by the first on both sides): each
    port rank yields, bit for bit, the batches the JAX pipeline samples
    for that rank, and leaves the shared stream where the JAX one is."""
    from tests.test_torch_sampler import assert_same_batch
    jp, tps, targets, jchunks, tchunks = _pipelines(small_graph, case)
    try:
        jp.final_epoch = 1
        for tp in tps:
            tp.final_epoch = 1
        for epoch in (0, 1):
            groups = list(jp._step_groups(targets, jchunks, epoch))
            assert len(groups) == {"global": 2, "local_shuffle": 2,
                                   "pagraph": 4, "uneven_skew": 3}[case]
            for r, tp in enumerate(tps):
                got = list(tp.train_epoch(targets, tchunks, epoch=epoch))
                assert len(got) == len(groups)
                for t, g in zip(got, groups):
                    assert_same_batch(t, g[r])
                assert (tp._rng.bit_generator.state
                        == jp._rng.bit_generator.state)
    finally:
        for tp in tps:
            tp.close()
        jp.pool.shutdown(wait=True, cancel_futures=True)


def test_more_chunks_than_ranks_sample_like_jax(small_graph):
    """The composed cache's PaGraph chunks, one a part: two lists for one
    data rank. Both pipelines shuffle both lists, take the step count
    over both (the longer list's 4 steps of 64) and sample list 0, bit
    for bit alike; fewer lists than ranks still raises."""
    from gnn_tpu.sampling import pipeline as jpl
    from gnn_tpu_torch.sampling import pipeline as tpl
    from tests.test_torch_sampler import _cfgs, assert_same_batch
    lap, jcfg, tcfg = _cfgs(small_graph, "resident", True)
    jpla, tpla = _placements(small_graph, lap, "pagraph")
    chunks = [c[:n] for c, n in zip(tpla.train_nodes_per_dev, (100, 200))]
    for a, b in zip(jpla.train_nodes_per_dev, chunks):
        np.testing.assert_array_equal(b, a[:len(b)])
    jp = jpl.BatchPipeline(jcfg, lap, small_graph.labels, world_size=1,
                           pool_num=2, local_shuffle=True, seed=3)
    tp = tpl.BatchPipeline(tcfg, lap, small_graph.labels, pool_num=2,
                           local_shuffle=True, seed=3)
    try:
        groups = list(jp._step_groups(None, chunks, 0))
        got = list(tp.train_epoch(None, chunks, epoch=0))
        assert len(got) == len(groups) == 4
        for t, g in zip(got, groups):
            assert_same_batch(t, g[0])
        assert tp._rng.bit_generator.state == jp._rng.bit_generator.state
    finally:
        tp.close()
        jp.pool.shutdown(wait=True, cancel_futures=True)
    two = tpl.BatchPipeline(tcfg, lap, small_graph.labels, pool_num=1,
                            world_size=2, rank=0)
    try:
        with pytest.raises(ValueError, match="1 rank chunks for 2 ranks"):
            next(two.train_epoch(None, chunks[:1], epoch=0))
    finally:
        two.close()


def test_sharded_test_sweep_matches_jax(small_graph):
    """The sharded sweep of 3 batches over 2 ranks with locality skews:
    rank r samples batches r, r + 2 with rank (j % 2)'s skew, as the JAX
    pipeline does; rank 1's second batch is the filler, the last batch
    with empty masks, as in the JAX stack."""
    from tests.test_torch_sampler import assert_same_batch
    jp, tps, _, _, _ = _pipelines(small_graph, "uneven_skew", pool_num=1)
    nodes = small_graph.test_nodes[:3 * 128 - 5]
    recorded = []
    sample = jp._sample_one

    def record(*a, **k):
        recorded.append(sample(*a, **k))
        return recorded[-1]
    jp._sample_one = record
    try:
        stacks = list(jp.eval_batches_sharded(nodes, 128))
        assert len(recorded) == 3 and len(stacks) == 2
        for r, tp in enumerate(tps):
            got = list(tp.eval_batches_sharded(nodes, 128))
            assert len(got) == 2
            for i, t in enumerate(got):
                j = 2 * i + r
                if j < 3:
                    assert_same_batch(t, recorded[j])
                    continue
                assert not t.label_mask.any() and not t.input_mask.any()
                assert not stacks[i].label_mask[r].any()
                assert_same_batch(dataclasses.replace(
                    t, label_mask=recorded[2].label_mask,
                    input_mask=recorded[2].input_mask), recorded[2])
            assert tp._rng.bit_generator.state == jp._rng.bit_generator.state
    finally:
        for tp in tps:
            tp.close()
        jp.pool.shutdown(wait=True, cancel_futures=True)


def test_primed_epoch_matches_a_fresh_one(small_graph):
    """An epoch primed by the one before yields the batches a fresh
    pipeline samples for it; after the config object is replaced (the
    tuner's new factor), the prime is dropped and the epoch sampled
    under the new config."""
    from tests.test_torch_sampler import _cfgs, assert_same_batch
    from gnn_tpu_torch.sampling import pipeline as tpl
    lap, _, cfg = _cfgs(small_graph, "resident", True)
    targets = small_graph.train_nodes[:300]

    def pipe():
        return tpl.BatchPipeline(cfg, lap, small_graph.labels, pool_num=2,
                                 seed=5, world_size=2, rank=1)
    a, b, c = pipe(), pipe(), pipe()
    try:
        list(a.train_epoch(targets, epoch=0))
        assert a._primed is not None and a._primed["eid"] == 2
        primed = a._primed["futures"]
        got = list(a.train_epoch(targets, epoch=1))
        assert all(f.done() for f in primed)
        want = list(b.train_epoch(targets, epoch=1))
        assert len(got) == len(want) == 3
        for t, w in zip(got, want):
            assert_same_batch(t, w)
        # a new config object: epoch 2's prime is discarded
        a.cfg = dataclasses.replace(a.cfg, scale_factor=2.0)
        c.cfg = a.cfg
        got = list(a.train_epoch(targets, epoch=2))
        want = list(c.train_epoch(targets, epoch=2))
        for t, w in zip(got, want):
            assert_same_batch(t, w)
    finally:
        for p in (a, b, c):
            p.close()


# --- the collectives and the feature cache ---

def test_world_of_one_is_a_noop():
    ctx = tdist.DistContext()
    a = torch.arange(3.0)
    tdist.all_reduce_sum_([a], ctx)
    ctx.barrier()
    assert a.tolist() == [0.0, 1.0, 2.0]
    assert tdist.sum_across_ranks([1.5, 2], ctx) == [1.5, 2]
    assert tdist.mean_across_ranks([1.5], ctx) == [1.5]
    assert tdist.broadcast_from_main([7.0], ctx) == [7.0]
    assert ctx.meta_device == torch.device("cpu")


def test_collectives_across_two_ranks(tmp_path):
    """One flat all_reduce over tensors of two shapes; sums, means and
    rank 0's broadcast, the same on both ranks."""
    spawn(worker.collectives_case, (), tmp_path)
    for r in range(2):
        with open(tmp_path / f"collectives{r}.json") as f:
            rec = json.load(f)
        assert rec["a"] == [[3.0] * 3] * 2
        assert rec["b"] == [0.0, 3.0, 6.0, 9.0]
        assert rec["sum"] == [1.0, 1.0]
        assert rec["mean"] == [0.5, 2.0]
        assert rec["bcast"] == [10.0]


@pytest.mark.parametrize("device_type,backend,cards,want,devices", [
    ("cpu", "auto", 0, "gloo", ["cpu", "cpu"]),
    ("cpu", "gloo", 0, "gloo", ["cpu", "cpu"]),
    ("cuda", "auto", 2, "nccl", ["cuda:0", "cuda:1"]),
    ("cuda", "gloo", 1, "gloo", ["cuda:0", "cuda:0"])])
def test_backend_and_devices(monkeypatch, device_type, backend, cards,
                             want, devices):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    got = tdist.resolve_backend(device_type, backend, 2)
    assert got == want
    assert [str(tdist.rank_device(device_type, got, r))
            for r in range(2)] == devices


@pytest.fixture(scope="module")
def cache_runs(small_graph, tmp_path_factory):
    """Both ranks' CachedFeatures gathers (float32 and bfloat16) of three
    batches each, the last of rank 1 fully masked (it asks for nothing
    but must take part in the exchange)."""
    from gnn_tpu_torch.placement.engine import (compute_sample_prob,
                                                greedy_placement)
    from gnn_tpu_torch.sampling.ladies import SamplerConfig, ladies_sample
    from gnn_tpu_torch.utils.normalize import build_laplacian
    g = small_graph
    lap = build_laplacian(g.adj_full, "graphsage")
    n = lap.shape[0]
    pl = greedy_placement(compute_sample_prob(lap, g.train_nodes, 2),
                          per_dev=n // 8, num_devs=2, alpha=0.0)
    cfg = SamplerConfig(batch_size=32, samp_num=64, orders=(1, 1),
                        num_nodes=n, num_classes=g.num_classes)
    mbs = [[ladies_sample(cfg, 10 * r + i,
                          g.train_nodes[(2 * i + r) * 32:][:32], lap,
                          g.labels) for i in range(3)] for r in range(2)]
    last = mbs[1][2]
    mbs[1][2] = dataclasses.replace(
        last, input_mask=np.zeros_like(last.input_mask))
    batches = [[(mb.input_nodes, mb.input_mask) for mb in rank]
               for rank in mbs]
    out = tmp_path_factory.mktemp("cache")
    spawn(worker.cache_case, (g.feats, pl, batches), out)
    got = [dict(np.load(out / f"cache{r}.npz")) for r in range(2)]
    return pl, mbs, got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_gather_is_exact(small_graph, cache_runs, dtype):
    """Each rank's gather, and its host path, equals
    ``feats[input_nodes] * mask`` (the table rounded to ``dtype``)
    exactly, and so does the JAX CachedFeatures on two virtual devices
    for the same batches; rows came from the rank's own buffer, its
    peer's and the host."""
    import jax.numpy as jnp
    import ml_dtypes

    from gnn_tpu.parallel.feature_cache import CachedFeatures as JCached
    from gnn_tpu.parallel.mesh import make_mesh
    from tests.test_feature_cache import _gather_via_mesh
    pl, mbs, got = cache_runs
    feats = small_graph.feats
    table = (feats.astype(ml_dtypes.bfloat16).astype(np.float32)
             if dtype == "bfloat16" else feats)
    jcache = JCached(feats, pl, dtype=jnp.bfloat16 if dtype == "bfloat16"
                     else np.float32)
    for i in range(3):
        pair = [mbs[r][i] for r in range(2)]
        stacked = types.SimpleNamespace(
            input_nodes=np.stack([mb.input_nodes for mb in pair]),
            input_mask=np.stack([mb.input_mask for mb in pair]))
        jx = _gather_via_mesh(jcache, stacked, make_mesh(2), 2)
        for r, mb in enumerate(pair):
            want = table[mb.input_nodes] * mb.input_mask[:, None]
            np.testing.assert_array_equal(got[r][f"{dtype}_{i}"], want)
            np.testing.assert_array_equal(got[r][f"{dtype}_host_{i}"], want)
            np.testing.assert_array_equal(jx[r], want)
    for r in range(2):
        local, peer, host = got[r][f"{dtype}_stats"]
        valid = sum(int(mb.input_mask.sum()) for mb in mbs[r])
        assert local + peer + host == valid
        assert local > 0 and peer > 0 and host > 0


# --- training: the port's two ranks against the JAX 2-device Trainer ---

def _jax_trainer(g, monkeypatch, source="replicated"):
    """The JAX Trainer on a 2-device mesh at the worker's configuration,
    its per-leaf transport (so each step's loss can be read), with every
    step's mean loss recorded in ``jtr.step_losses``."""
    import jax  # noqa: F401  (the JAX side of the comparison)

    from gnn_tpu.models.gnn import build_model as jbuild
    from gnn_tpu.ops.hotdense import HotSpec, build_hot_dense
    from gnn_tpu.ops.residentgraph import build_resident_graph
    from gnn_tpu.parallel.feature_cache import CachedFeatures as JCached
    from gnn_tpu.parallel.mesh import make_mesh
    from gnn_tpu.placement.engine import compute_sample_prob
    from gnn_tpu.sampling.ladies import SamplerConfig
    from gnn_tpu.sampling.pipeline import BatchPipeline
    from gnn_tpu.train.trainer import Trainer
    from gnn_tpu.utils.normalize import build_laplacian

    monkeypatch.setenv("GNN_TPU_PACKED", "0")
    lap = build_laplacian(g.adj_full, "graphsage")
    spec = HotSpec.from_sample_prob(
        compute_sample_prob(lap, g.train_nodes, 2), worker.HOT_K)
    d, dt = build_hot_dense(lap, spec, np.float32)
    cfg = SamplerConfig(num_nodes=lap.shape[0], num_classes=g.num_classes,
                        adj_format="resident", hot_spec=spec,
                        resident_val_free=True, resident_stream_tiles=True,
                        **worker.SAMPLER)
    pipe = BatchPipeline(cfg, lap, g.labels, world_size=2,
                         pool_num=worker.POOL, seed=worker.SEED)
    fs = None
    if source == "cached":
        fs = JCached(g.feats, _placements(g, lap)[0])
    jtr = Trainer(jbuild("graphsage", worker.NHID, worker.SAMPLER["orders"],
                         g.num_classes, dropout=0.0), pipe, g.feats,
                  mesh=make_mesh(2), lr=0.01, sigmoid_loss=True,
                  seed=worker.SEED, feature_source=fs,
                  resident_graph=build_resident_graph(lap, spec, d, dt))
    jtr.step_losses = []
    step = jtr.fns.train_step

    def recorded(*a):
        params, opt_state, loss = step(*a)
        jtr.step_losses.append(float(loss))
        return params, opt_state, loss
    jtr.fns = dataclasses.replace(jtr.fns, train_step=recorded)
    return jtr


def _init(jtr, targets, scale_linear=1.0):
    """Initialise the JAX params (its linear kernel times
    ``scale_linear``) and return them as the port's state dict."""
    import jax

    from gnn_tpu.parallel.mesh import put_replicated
    from gnn_tpu_torch.weights import params_from_flax
    jtr._init_params(jtr._peek_batch(targets))
    def scaled(path, a):
        keys = [getattr(k, "key", None) for k in path]
        return np.asarray(a) * (scale_linear if keys[-2:] == ["linear",
                                                             "kernel"]
                                else 1.0)
    host = jax.tree_util.tree_map_with_path(scaled, jtr.params)
    jtr.params = put_replicated(jtr.mesh, host)
    return params_from_flax(host)


def _clip_setup(g, init):
    """A linear-layer scale at which rank 0's first gradient (one target
    node) has a global norm above 5 and rank 1's (64 nodes) below, found
    on the port in this process; returns (scale, chunks, norms)."""
    chunks = [g.train_nodes[:1], g.train_nodes[300:364]]
    b = worker.build()
    for scale in (2.0, 3.0, 4.0, 6.0, 8.0):
        params = dict(init, **{"linear.weight":
                               init["linear.weight"] * scale})
        norms = []
        for r in range(2):
            tr = worker.make_trainer(b, params, r)
            try:
                norms.append(worker.first_grads(tr, None, chunks)[1])
            finally:
                tr.pipeline.close()
        if norms[0] > 5.0 > norms[1]:
            return scale, chunks, norms
    raise AssertionError(f"no scale puts 5 between the ranks' norms: "
                         f"{norms}")


TRAIN_TARGETS = 384      # three steps of 64 a rank


@pytest.fixture(scope="module")
def dp_runs(small_graph, tmp_path_factory):
    """The port's two ranks through worker.train_case: the replicated and
    cached epochs from the JAX package's initial weights, and the clip
    case."""
    mp = pytest.MonkeyPatch()
    try:
        jtr = _jax_trainer(small_graph, mp)
        targets = small_graph.train_nodes[:TRAIN_TARGETS]
        init = _init(jtr, targets)
        jtr.close()
    finally:
        mp.undo()
    scale, chunks, norms = _clip_setup(small_graph, init)
    clip_init = dict(init, **{"linear.weight":
                              init["linear.weight"] * scale})
    out = tmp_path_factory.mktemp("train")
    spawn(worker.train_case, (init, targets, clip_init, chunks), out)
    got = [dict(np.load(out / f"train{r}.npz")) for r in range(2)]
    return dict(init=init, targets=targets, scale=scale, chunks=chunks,
                norms=norms, got=got)


def _params(rec, prefix):
    return {k[len(prefix):]: v for k, v in rec.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("source", ["replicated", "cached"])
def test_dp_training_matches_jax(small_graph, dp_runs, monkeypatch,
                                 source):
    """One epoch (three steps a rank) of the port's two ranks against the
    JAX Trainer on two devices, from the same weights: every step's mean
    loss and the final parameters agree, and the ranks hold bitwise the
    same parameters."""
    import jax

    from gnn_tpu_torch.weights import params_from_flax
    jtr = _jax_trainer(small_graph, monkeypatch, source)
    try:
        init = _init(jtr, dp_runs["targets"])
        for k, v in dp_runs["init"].items():
            torch.testing.assert_close(init[k], v, rtol=0, atol=0)
        jtr.train_epoch(dp_runs["targets"], 0)
        want = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                       jtr.params))
    finally:
        jtr.close()
    r0, r1 = dp_runs["got"]
    assert len(jtr.step_losses) == 3
    np.testing.assert_array_equal(r1[f"{source}_losses"],
                                  r0[f"{source}_losses"])
    np.testing.assert_allclose(r0[f"{source}_losses"], jtr.step_losses,
                               rtol=1e-4, atol=1e-5)
    assert str(r0[f"{source}_digest"]) == str(r1[f"{source}_digest"])
    got, other = (_params(r, f"{source}_param_") for r in (r0, r1))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(other[k], got[k])
        np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_clip_then_sum_matches_jax(small_graph, dp_runs, monkeypatch):
    """One step in which rank 0's gradient norm is above 5 and rank 1's
    below: Adam's first moment after it (0.1 x the update's gradient)
    equals the JAX step's and the sum of the per-rank clipped gradients,
    and misses both their mean and the clip of their sum."""
    import jax

    from gnn_tpu_torch.weights import params_from_flax
    n0, n1 = dp_runs["norms"]
    r0, r1 = dp_runs["got"]
    assert float(r0["clip_norm"]) == pytest.approx(n0, rel=1e-5)
    assert float(r1["clip_norm"]) == pytest.approx(n1, rel=1e-5)
    assert n0 > 5.0 > n1
    jtr = _jax_trainer(small_graph, monkeypatch)
    try:
        _init(jtr, dp_runs["targets"], dp_runs["scale"])
        jtr.train_epoch(None, 0, dp_runs["chunks"])
        jmu = params_from_flax(jax.tree_util.tree_map(
            np.asarray, jtr.opt_state[0].mu))
    finally:
        jtr.close()
    names = sorted(jmu)

    def flat(d):
        return np.concatenate([np.ravel(np.asarray(d[k])) for k in names])

    mu, mu1 = flat(_params(r0, "clip_mu_")), flat(_params(r1, "clip_mu_"))
    g0, g1 = flat(_params(r0, "clip_grad_")), flat(_params(r1, "clip_grad_"))
    np.testing.assert_array_equal(mu1, mu)

    def clip(g):
        return g * min(1.0, 5.0 / (np.linalg.norm(g) + 1e-6))

    summed = 0.1 * (clip(g0) + clip(g1))

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    # agreement within 1e-4; each wrong order misses by 100 times that
    assert rel(mu, flat(jmu)) < 1e-4
    assert rel(mu, summed) < 1e-4
    assert rel(summed / 2, flat(jmu)) > 1e-2
    assert rel(0.1 * clip(g0 + g1), flat(jmu)) > 1e-2


# --- the CLI ---

def test_cli_trains_two_ranks_on_cpu(tmp_path):
    """``--n_devices 2 --feature_cache --device cpu`` through ``main``:
    two gloo ranks train, rank 0 writes one metrics.jsonl with the test
    F1 and the communication bucket, each rank its record, and both
    hold the same parameters after each epoch."""
    from gnn_tpu_torch import cli as tcli
    save = tmp_path / "save"
    argv = TINY + ["--device", "cpu", "--n_devices", "2", "--feature_cache",
                   "--epoch_num", "2", "--test", "--op_timing",
                   "--save_dir", str(save)]
    with short_timeouts():
        assert tcli.main(argv) == 0
    with open(save / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    eps = [r for r in recs if "step_losses" in r]
    assert [r["epoch"] for r in eps] == [0, 1]
    # 720 train nodes in two chunks of 360: six steps of 64 a rank
    assert all(len(r["step_losses"]) == 6 for r in eps)
    assert all(math.isfinite(v) for r in eps for v in r["step_losses"])
    assert all(r["communication_s"] > 0 for r in eps)
    assert 0.0 <= recs[-1]["test_f1"] <= 1.0
    ranks = []
    for r in range(2):
        with open(save / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    assert [e["param_digest"] for e in ranks[0]["epochs"]] == \
        [e["param_digest"] for e in ranks[1]["epochs"]]
    for rec in ranks:
        assert [e["step_losses"] for e in rec["epochs"]] == \
            [r["step_losses"] for r in eps]
        assert rec["cache"]["batches"] == 12
        assert rec["cache"]["rows_peer"] > 0
    # two test batches of 128 over 240 test nodes, one a rank
    assert [rec["test_batches"] for rec in ranks] == [1, 1]
    assert not [f for f in os.listdir(save) if f.startswith(".rendezvous")]


def _records(save):
    with open(save / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    ranks = []
    for r in range(2):
        with open(save / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    return [r for r in recs if "step_losses" in r], ranks


@pytest.mark.parametrize("flags", [
    ["--locality_sampling", "--scale_factor", "4"],
    ["--local_shuffle", "--pagraph"], ["--profile_dir"]])
def test_cli_two_ranks_extras(tmp_path, flags):
    """Locality sampling (each rank skews toward its own buffer; rank 0's
    tuner factor holds on both), PaGraph's per-rank train sets, and a
    trace of epoch 1 written by rank 0 alone, over two epochs of two
    ranks; the ranks' parameters stay the same."""
    from gnn_tpu_torch import cli as tcli
    save = tmp_path / "save"
    if flags == ["--profile_dir"]:
        flags = ["--profile_dir", str(tmp_path / "prof")]
    with short_timeouts():
        assert tcli.main(TINY + ["--device", "cpu", "--n_devices", "2",
                                 "--epoch_num", "2", "--save_dir",
                                 str(save)] + flags) == 0
    eps, ranks = _records(save)
    assert [r["epoch"] for r in eps] == [0, 1]
    assert all(math.isfinite(v) for r in eps for v in r["step_losses"])
    assert [e["param_digest"] for e in ranks[0]["epochs"]] == \
        [e["param_digest"] for e in ranks[1]["epochs"]]
    if flags[0] == "--locality_sampling":
        assert all(r["scale_factor"] >= 4.0 for r in eps)
        assert all(0.0 < r["skew_share"] <= 1.0 for r in eps)
    if flags[0] == "--profile_dir":
        assert os.listdir(flags[1]) == ["trace_epoch1.json"]


def test_cli_two_ranks_resume_replays_the_run(tmp_path):
    """Two ranks, three epochs uninterrupted, against two epochs and a
    ``--resume`` to three: the resumed run trains epoch 2 only, with the
    uninterrupted run's step losses (rtol 1e-5, as the one-device resume
    test), and its two ranks end with the same parameters."""
    from gnn_tpu_torch import cli as tcli
    base = TINY + ["--device", "cpu", "--n_devices", "2", "--lr_warmup",
                   "20"]
    a, b = tmp_path / "a", tmp_path / "b"
    with short_timeouts():
        assert tcli.main(base + ["--epoch_num", "3", "--save_dir",
                                 str(a)]) == 0
        assert tcli.main(base + ["--epoch_num", "2", "--save_dir",
                                 str(b)]) == 0
        assert tcli.main(base + ["--epoch_num", "3", "--resume",
                                 "--save_dir", str(b)]) == 0
    eps_a, ranks_a = _records(a)
    eps_b, ranks_b = _records(b)
    assert [r["epoch"] for r in eps_b] == [0, 1, 2]
    assert [e["epoch"] for e in ranks_b[1]["epochs"]] == [2]
    np.testing.assert_allclose(eps_b[2]["step_losses"],
                               eps_a[2]["step_losses"], rtol=1e-5)
    assert ranks_b[0]["epochs"][0]["param_digest"] == \
        ranks_b[1]["epochs"][0]["param_digest"]


@pytest.mark.parametrize("argv", [
    ["--n_devices", "2"],
    ["--n_devices", "2", "--device", "cpu", "--dist_backend", "nccl"]])
def test_cli_refuses_nccl_before_any_rank_starts(tmp_path, monkeypatch,
                                                 argv):
    """NCCL with two ranks and one visible card, or on the CPU, raises
    before a rank is started."""
    from gnn_tpu_torch import cli as tcli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def no_spawn(*a, **k):
        raise AssertionError("a rank was started")
    monkeypatch.setattr(tdist, "spawn_ranks", no_spawn)
    with pytest.raises(ValueError, match="NCCL"):
        tcli.main(TINY + ["--save_dir", str(tmp_path)] + argv)


# --- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_two_gloo_ranks_share_the_card(cuda_device, tmp_path):
    """Two gloo ranks on ``cuda:0``: the cache's gather of a batch equals
    the table's rows exactly, and an epoch through the cache (K1 on the
    resident path) leaves both ranks with the same losses and
    parameters."""
    from gnn_tpu_torch.models.gnn import build_model
    g = worker.build()["graph"]
    init = build_model("graphsage", worker.NHID, worker.SAMPLER["orders"],
                       g.num_classes, n_feats=g.feats.shape[1],
                       dropout=0.0).state_dict()
    spawn(worker.cuda_case, (init,), tmp_path)
    recs = []
    for r in range(2):
        with open(tmp_path / f"cuda{r}.json") as f:
            recs.append(json.load(f))
    assert [rec["device"] for rec in recs] == ["cuda:0", "cuda:0"]
    assert all(rec["gather_exact"] for rec in recs)
    assert recs[0]["losses"] == recs[1]["losses"]
    assert all(math.isfinite(v) for v in recs[0]["losses"])
    assert recs[0]["digest"] == recs[1]["digest"]
