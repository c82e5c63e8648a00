"""The port's single-device extras (the twins of `tests/test_aux.py` and
`tests/test_residentgraph.py`'s resume and op-timing tests): the metrics
epoch's locality skew share, the `ScaleFactorTuner` against the JAX
package's, the tuner skipping the first epoch, checkpoint save / restore
with the update count, kill-and-resume on the COO and resident paths, the
best params surviving a resume, a resumed GAT run with an lr warmup
against the JAX package's uninterrupted run, the op-timing buckets and
the profiler trace. Everything runs on the CPU."""
import math
import os

import numpy as np
import pytest
import torch

from gnn_tpu.train.metrics import ScaleFactorTuner as JTuner
from gnn_tpu_torch.models.gnn import build_model
from gnn_tpu_torch.ops.hotdense import HotSpec, build_hot_dense
from gnn_tpu_torch.ops.residentgraph import build_resident_graph
from gnn_tpu_torch.placement.engine import compute_sample_prob
from gnn_tpu_torch.sampling.ladies import SamplerConfig
from gnn_tpu_torch.sampling.pipeline import BatchPipeline
from gnn_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from gnn_tpu_torch.train.metrics import (EpochMetrics, MetricsRegistry,
                                         ScaleFactorTuner)
from gnn_tpu_torch.train.trainer import Trainer
from gnn_tpu_torch.utils.normalize import build_laplacian


def _trainer(graph, adj_format="coo", seed=3):
    """A port Trainer on ``graph`` (GraphSAGE nhid 32, orders 1,1, batch
    64, samp_num 128, CE loss); the resident path with a float32 hot
    block of 256 and the edge-stream tiles."""
    lap = build_laplacian(graph.adj_full, "graphsage")
    kw = dict(batch_size=64, samp_num=128, orders=(1, 1),
              num_nodes=lap.shape[0], num_classes=graph.num_classes,
              adj_format=adj_format)
    rg = None
    if adj_format == "resident":
        spec = HotSpec.from_sample_prob(
            compute_sample_prob(lap, graph.train_nodes, 2), 256)
        rg = build_resident_graph(lap, spec,
                                  *build_hot_dense(lap, spec, torch.float32,
                                                   "cpu"))
        kw.update(hot_spec=spec, resident_val_free=True,
                  resident_stream_tiles=True)
    pipe = BatchPipeline(SamplerConfig(**kw), lap, graph.labels, pool_num=2)
    net = build_model("graphsage", 32, (1, 1), graph.num_classes,
                      n_feats=graph.feats.shape[1])
    return Trainer(net, pipe, graph.feats, lr=0.05, sigmoid_loss=False,
                   seed=seed, resident_graph=rg, device="cpu")


@pytest.fixture
def fit(small_graph):
    """``fit(epochs, adj_format="coo", **kw)``: a fresh trainer's
    ``Trainer.fit`` on ``small_graph``; returns ``(trainer, history)``.
    Every pipeline is closed after the test."""
    made = []

    def run(epochs, adj_format="coo", **kw):
        tr = _trainer(small_graph, adj_format)
        made.append(tr)
        return tr, tr.fit(small_graph.train_nodes, small_graph.valid_nodes,
                          epochs, log=False, **kw)
    yield run
    for tr in made:
        tr.pipeline.close()


def test_epoch_logs_skew_share(small_graph, tmp_path):
    """Each epoch's record carries the mean share of its batches' layer-0
    input nodes in the skew set: NaN without a skew, the pipeline's
    per-batch shares averaged with one."""
    from tests.test_torch_train import locality_skews
    tr = _trainer(small_graph)
    tr.pipeline.close()
    _, tskew = locality_skews(small_graph, tr.pipeline.lap)
    tr.pipeline = BatchPipeline(tr.pipeline.cfg, tr.pipeline.lap,
                                small_graph.labels, pool_num=2,
                                per_rank_skew=tskew)
    plain = _trainer(small_graph)
    metrics = MetricsRegistry(str(tmp_path / "m.jsonl"))
    try:
        m = tr.train_epoch(small_graph.train_nodes, 0)
        shares = [tr.pipeline.skew_share(mb) for mb in
                  tr.pipeline.train_epoch(small_graph.train_nodes, epoch=0)]
        assert math.isclose(m.skew_share, float(np.mean(shares)))
        assert 0.0 < m.skew_share < 1.0
        assert math.isnan(plain.train_epoch(small_graph.train_nodes,
                                            0).skew_share)
        tr.fit(small_graph.train_nodes, small_graph.valid_nodes, 1,
               log=False, metrics=metrics)
        assert metrics.records[-1]["skew_share"] == tr.history[0].skew_share
    finally:
        tr.pipeline.close()
        plain.pipeline.close()


@pytest.mark.parametrize("initial,seq", [
    # double, double, bisect, in band
    (1.0, [(0.5, 1.0), (0.3, 1.0), (0.05, 1.0), (0.15, 1.0)]),
    # starts above 1 and undershoots at once: bisects from the initial
    (4.0, [(0.01, 1.0), (0.01, 1.0), (0.5, 1.0), (0.01, 1.0),
           (0.15, 1.0)]),
    # doubles to the cap and stops there
    (2.0, [(1.0, 1.0)] * 6),
    # at factor 1 an undershoot stops the controller
    (1.0, [(0.01, 1.0), (0.5, 1.0)]),
    # an epoch without execution time leaves it as it was
    (3.0, [(0.5, 0.0), (0.5, 2.0), (0.01, 2.0), (0.3, 1.0)]),
])
def test_scale_factor_tuner_matches_jax(initial, seq):
    t, j = ScaleFactorTuner(initial), JTuner(initial)
    got = [t.update(*mv) for mv in seq]
    want = [j.update(*mv) for mv in seq]
    assert got == want
    assert t.active == j.active


def test_tuner_skips_first_epoch(small_graph, monkeypatch):
    """fit(locality_tuner=True) feeds the tuner every epoch after the
    first trained one: epoch 0's tiny movement / execution ratio would
    stop the controller at factor 1."""
    tr = _trainer(small_graph)
    tr.pipeline.close()

    def fake_epoch(train_nodes, epoch, rank_chunks=None,
                   keep_last_batch=False):
        exec_t = 100.0 if epoch == 0 else 1.0
        return EpochMetrics(epoch=epoch, train_loss=1.0, valid_loss=1.0,
                            valid_f1=0.0, data_movement_time=5.0,
                            execution_time=exec_t, sample_wait_time=0.0)

    monkeypatch.setattr(tr, "train_epoch", fake_epoch)
    monkeypatch.setattr(tr, "evaluate", lambda *a, **k: (0.0, 1.0))
    tr.fit(small_graph.train_nodes, small_graph.valid_nodes, epochs=3,
           log=False, locality_tuner=True)
    # epochs 1 and 2 (ratio 5.0) double twice: 1 -> 2 -> 4
    assert tr.pipeline.cfg.scale_factor == 4.0


def test_save_restore_roundtrip(fit, tmp_path):
    """save() then restore() into a trainer in another state brings
    back its params, optimizer state, update count and the step."""
    tr, _ = fit(1)
    path = tr.save(str(tmp_path), step=7)
    assert os.path.exists(path)
    want = {k: v.clone() for k, v in tr.net.state_dict().items()}
    want_opt = tr.optimizer.state_dict()

    tr2, _ = fit(2)
    assert tr2.n_updates != tr.n_updates
    assert tr2.restore(str(tmp_path)) == 7
    assert tr2.n_updates == tr.n_updates
    for k, v in tr2.net.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    got_opt = tr2.optimizer.state_dict()
    for i, st in want_opt["state"].items():
        for key, v in st.items():
            torch.testing.assert_close(got_opt["state"][i][key], v, rtol=0,
                                       atol=0)


def test_checkpoint_without_update_count_raises(tmp_path):
    """An optimizer state saved without its update count cannot be
    resumed (the lr warmup would restart); params alone load."""
    params = {"w": torch.ones(2)}
    with pytest.raises(ValueError, match="together"):
        save_checkpoint(str(tmp_path), params, opt_state={"state": {}})
    torch.save({"params": params, "step": 3, "best_val": 0.5,
                "opt_state": {"state": {}, "param_groups": []}},
               os.path.join(tmp_path, "old_model.pt"))
    with pytest.raises(ValueError, match="update count"):
        load_checkpoint(str(tmp_path), "old")
    save_checkpoint(str(tmp_path), params, step=2, name="plain")
    p, step, opt, best, n = load_checkpoint(str(tmp_path), "plain")
    assert step == 2 and opt is None and n is None
    torch.testing.assert_close(p["w"], params["w"])


@pytest.mark.parametrize("adj_format,split", [("coo", 2), ("resident", 1)])
def test_kill_and_resume_reproduces_loss_curve(fit, tmp_path, adj_format,
                                               split):
    """Train uninterrupted, against train ``split`` epochs, 'crash', and
    fit(resume=True) on a fresh trainer: the resumed epochs reproduce
    the uninterrupted loss curve (epoch-seeded sampling and dropout,
    restored optimizer state and update count)."""
    epochs = split + 2
    _, full = fit(epochs, adj_format)
    ck = str(tmp_path / "ck")
    fit(split, adj_format, checkpoint_dir=ck)
    tr_b, hist_b = fit(epochs, adj_format, checkpoint_dir=ck, resume=True)
    assert [m.epoch for m in hist_b] == list(range(split, epochs))
    for m in hist_b:
        ref = full[m.epoch]
        np.testing.assert_allclose(m.train_loss, ref.train_loss, rtol=1e-5)
        np.testing.assert_allclose(m.valid_loss, ref.valid_loss, rtol=1e-5)
    assert tr_b.n_updates == sum(len(m.step_losses) for m in full)
    assert tr_b.best_val >= 0


def test_resume_restores_best_params_for_test_sweep(small_graph, fit,
                                                    tmp_path):
    """A resume at the final epoch trains nothing, returns [] and keeps
    the best params and watermark for the test sweep."""
    ck = str(tmp_path / "ck")
    tr_a, _ = fit(3, checkpoint_dir=ck)
    assert tr_a.best_params is not None
    tr_b, hist_b = fit(3, checkpoint_dir=ck, resume=True)
    assert hist_b == []
    assert tr_b.best_val == pytest.approx(tr_a.best_val)
    assert tr_b.best_params.keys() == tr_a.best_params.keys()
    for k, v in tr_a.best_params.items():
        torch.testing.assert_close(tr_b.best_params[k], v, rtol=0, atol=0)
    assert 0.0 <= tr_b.test(small_graph.test_nodes, 64) <= 1.0


def test_resumed_gat_warmup_matches_jax(small_graph, tmp_path):
    """GAT on the resident path with a 3-update lr warmup and weights
    copied from flax: the JAX package trains 4 one-step epochs
    uninterrupted; the port trains 2, crashes, and resumes for 2. Every
    epoch's train and val loss matches (a resume that lost the update
    count would restart the warmup at epoch 2)."""
    from tests.test_torch_train import build_pair
    jtr, make_torch_trainer, targets = build_pair(small_graph, "gat",
                                                  lr=0.01, lr_warmup=3)
    ck = str(tmp_path / "ck")
    try:
        jh = jtr.fit(targets, small_graph.valid_nodes, 4, log=False)
    finally:
        jtr.close()
    hist = []
    for epochs in (2, 4):
        ttr = make_torch_trainer()
        try:
            hist += ttr.fit(targets, small_graph.valid_nodes, epochs,
                            log=False, checkpoint_dir=ck,
                            resume=epochs == 4)
        finally:
            ttr.pipeline.close()
    assert [m.epoch for m in hist] == [0, 1, 2, 3]
    assert ttr.n_updates == 4
    for m, j in zip(hist, jh):
        np.testing.assert_allclose([m.train_loss, m.valid_loss],
                                   [j.train_loss, j.valid_loss],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("adj_format", ["coo", "resident"])
def test_op_timing_buckets(fit, adj_format):
    """fit(op_timing=True) fills finite spmm buckets above 0 and a
    communication bucket of 0.0, and they reach the epoch line; the
    probe's result is cached for the current scale factor."""
    tr, hist = fit(1, adj_format, op_timing=True)
    m = hist[0]
    assert math.isfinite(m.spmm_fwd_time) and m.spmm_fwd_time > 0
    assert math.isfinite(m.spmm_bwd_time) and m.spmm_bwd_time > 0
    assert m.communication_time == 0.0
    assert "spmm" in m.format() and "comm" in m.format()
    # the probe's batch is not kept past the measurement
    assert tr.last_batch is None
    assert tr.measure_op_buckets(None) is tr._op_buckets[1]


def test_profile_trace_of_epoch_1(fit, tmp_path):
    """fit(profile_dir=...) writes a Chrome trace of epoch 1: two epochs
    write one, one epoch writes none."""
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    fit(1, profile_dir=one)
    assert not os.path.exists(one)
    fit(2, profile_dir=two)
    assert os.listdir(two) == ["trace_epoch1.json"]
    with open(os.path.join(two, "trace_epoch1.json")) as f:
        assert "traceEvents" in f.read(4096)


# --- the host modules: reorder, shared memory, the rank span ---

def test_reorder_bit_equal_to_jax(small_graph):
    """`degree_order`, `reorder_graph` and `reorder_dataset` give the JAX
    package's arrays bit for bit; the reordered graph keeps its edges,
    features and labels (the JAX ``test_reorder_preserves_graph``)."""
    from gnn_tpu.data import reorder as jre
    from gnn_tpu_torch.data import reorder as tre
    g = small_graph
    order = tre.degree_order(g.adj_full)
    np.testing.assert_array_equal(order, jre.degree_order(g.adj_full))
    adj, new_of_old = tre.reorder_graph(g.adj_full, order)
    jadj, jnew = jre.reorder_graph(g.adj_full, order)
    np.testing.assert_array_equal(new_of_old, jnew)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(adj, f), getattr(jadj, f))
    g2, j2 = tre.reorder_dataset(g), jre.reorder_dataset(g)
    for f in ("feats", "train_nodes", "valid_nodes", "test_nodes"):
        np.testing.assert_array_equal(getattr(g2, f), getattr(j2, f))
    assert (g2.labels != j2.labels).nnz == 0
    deg = np.asarray(g2.adj_full.sum(axis=1)).ravel()
    assert np.all(np.diff(deg) <= 1e-6)
    assert g2.adj_full.nnz == g.adj_full.nnz
    coo = g.adj_full.tocoo()
    u, v = coo.row[0], coo.col[0]
    assert g2.adj_full[new_of_old[u], new_of_old[v]] != 0
    np.testing.assert_array_equal(g2.feats[new_of_old[u]], g.feats[u])


def test_shared_csr_round_trip():
    """A CSR published in shared memory attaches as the same matrix,
    under segments named with the port's prefix."""
    import scipy.sparse as sp

    from gnn_tpu_torch.data.shared import (SharedArray, SharedCSR,
                                           attach_shared_array,
                                           attach_shared_csr)
    m = sp.random(50, 70, density=0.1, format="csr",
                  random_state=np.random.RandomState(0), dtype=np.float32)
    with SharedCSR(m) as sh:
        assert all(n.startswith("gnn_tpu_torch_") for n in sh.handle.names)
        m2, segs = attach_shared_csr(sh.handle)
        np.testing.assert_array_equal(m2.toarray(), m.toarray())
        for s in segs:
            s.close()
    a = np.arange(12, dtype=np.int64).reshape(3, 4)
    owner = SharedArray(a)
    try:
        b, seg = attach_shared_array(owner.handle)
        np.testing.assert_array_equal(b, a)
        del b
        seg.close()
    finally:
        owner.close()


def test_graph_bundle_attach_is_shared_not_copied(tmp_path):
    """Attaching a published bundle and reading all of it does not grow
    the attaching process's private (anonymous) memory by anything near
    the bundle's size (the JAX package's test of the same name)."""
    import subprocess
    import sys
    import textwrap

    import scipy.sparse as sp

    from gnn_tpu_torch.data.shared import GraphBundle
    rng = np.random.default_rng(0)
    feats = rng.random((400_000, 32), np.float32)
    ij = rng.integers(0, 20000, (2, 800_000))
    lap = sp.csr_matrix((rng.random(800_000, np.float32) + 0.5, tuple(ij)),
                        shape=(20000, 20000))
    path = str(tmp_path / "big_bundle.pkl")
    bundle = GraphBundle.publish(dict(feats=feats, lap=lap, n=20000), path)
    try:
        worker = textwrap.dedent(f"""
            from gnn_tpu_torch.data.shared import GraphBundle

            def rss_anon():
                with open('/proc/self/status') as f:
                    for line in f:
                        if line.startswith('RssAnon'):
                            return int(line.split()[1]) * 1024
                return -1

            before = rss_anon()
            items, keep = GraphBundle.attach({path!r})
            s = float(items['feats'].sum()) + float(items['lap'].data.sum())
            grown = rss_anon() - before
            nbytes = items['feats'].nbytes + items['lap'].data.nbytes
            assert s != 0 and items['n'] == 20000
            print(f"GROWN {{grown}} OF {{nbytes}}", flush=True)
            assert grown < nbytes / 4, (grown, nbytes)
        """)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, PYTHONPATH=root)
        r = subprocess.run([sys.executable, "-c", worker], cwd=root, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "GROWN" in r.stdout
    finally:
        bundle.close()
    assert not os.path.exists(path)


@pytest.mark.parametrize("total,world,spans", [
    (100, 1, [(0, 100)]), (100, 2, [(0, 50), (50, 100)]),
    (10, 4, [(0, 3), (3, 6), (6, 9), (9, 10)])])
def test_process_local_rank_span(total, world, spans):
    """A rank's ``[start, end)`` share of host-side loading: the JAX
    helper's split by process, here by rank."""
    from gnn_tpu.parallel.multihost import process_local_rank_span as jspan
    from gnn_tpu_torch.parallel.dist import (DistContext,
                                             process_local_rank_span)
    got = [process_local_rank_span(total, DistContext(rank=r,
                                                      world_size=world))
           for r in range(world)]
    assert got == spans
    if world == 1:
        assert jspan(total) == spans[0]


def test_attached_bundle_trains_like_the_rebuilt_state(tmp_path):
    """Two processes: rank 0 builds the set-up and publishes it, rank 1
    attaches it (its features and Laplacian values in the shared
    segments) and each trains one epoch alone (rank 0's two batches)
    from the same weights: the same step losses, bit for bit."""
    import json

    import torch_dist_worker as dw
    from gnn_tpu_torch.parallel import dist as tdist
    saved = tdist.JOIN_TIMEOUT_S, tdist.COLLECTIVE_TIMEOUT_S
    tdist.JOIN_TIMEOUT_S, tdist.COLLECTIVE_TIMEOUT_S = 300.0, 120.0
    try:
        tdist.spawn_ranks(2, dw.bundle_case,
                          (str(tmp_path), str(tmp_path / "bundle.pkl"),
                           np.arange(64 * 3)),
                          rendezvous_dir=str(tmp_path))
    finally:
        tdist.JOIN_TIMEOUT_S, tdist.COLLECTIVE_TIMEOUT_S = saved
    recs = [json.load(open(tmp_path / f"bundle{r}.json")) for r in range(2)]
    assert recs[0]["shared"] == [False, False]
    assert recs[1]["shared"] == [True, True]
    assert len(recs[0]["losses"]) == 2
    assert recs[1]["losses"] == recs[0]["losses"]
