"""The port's span-and-counter recorder (`gnn_tpu_torch.utils.timing`):
self times and parents of nested spans, exact totals from several
threads, the epoch keys, spans on the profiler's timeline only while it
records, and the spans and counters that the training loop, the
pipeline, the val pass, the checkpoint, ``metrics.jsonl`` and the CLI's
set-up record, with the `EpochMetrics` buckets equal to the sums of
their spans. Everything runs on the CPU."""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from gnn_tpu_torch.data.synthetic import make_powerlaw_graph
from gnn_tpu_torch.models.gnn import build_model
from gnn_tpu_torch.ops.hotdense import HotSpec, build_hot_dense
from gnn_tpu_torch.ops.residentgraph import build_resident_graph
from gnn_tpu_torch.placement.engine import compute_sample_prob
from gnn_tpu_torch.sampling.ladies import SamplerConfig
from gnn_tpu_torch.sampling.pipeline import BatchPipeline
from gnn_tpu_torch.train.metrics import MetricsRegistry
from gnn_tpu_torch.train.trainer import Trainer
from gnn_tpu_torch.utils import timing
from gnn_tpu_torch.utils.normalize import build_laplacian
from gnn_tpu_torch.utils.timing import RECORDER, SETUP, Recorder


@pytest.fixture(scope="module")
def graph():
    return make_powerlaw_graph(num_nodes=1200, avg_degree=10, num_feats=16,
                               num_classes=5, seed=0)


def _trainer(graph, group=1):
    """GraphSAGE on the resident format (nhid 16, orders 1,1, batch 64,
    samp_num 128, a float32 hot block of 128) at ``group`` steps a
    dispatch."""
    lap = build_laplacian(graph.adj_full, "graphsage")
    spec = HotSpec.from_sample_prob(
        compute_sample_prob(lap, graph.train_nodes, 2), 128)
    rg = build_resident_graph(lap, spec, *build_hot_dense(
        lap, spec, torch.float32, "cpu"))
    cfg = SamplerConfig(batch_size=64, samp_num=128, orders=(1, 1),
                        num_nodes=lap.shape[0],
                        num_classes=graph.num_classes,
                        adj_format="resident", hot_spec=spec,
                        resident_val_free=True)
    pipe = BatchPipeline(cfg, lap, graph.labels, pool_num=2)
    net = build_model("graphsage", 16, (1, 1), graph.num_classes,
                      n_feats=graph.feats.shape[1])
    return Trainer(net, pipe, graph.feats, lr=0.05, sigmoid_loss=False,
                   resident_graph=rg, device="cpu",
                   steps_per_dispatch=group)


@pytest.fixture
def fresh():
    """The process's recorder, emptied and back at ``"setup"``."""
    RECORDER.reset()
    yield RECORDER
    RECORDER.reset()


def _spans(epoch):
    return RECORDER.totals(epoch)["spans"]


# --- the recorder ----------------------------------------------------

def test_nested_spans_self_time_and_parents():
    rec = Recorder()
    with rec.span("outer") as outer:
        time.sleep(0.002)
        with rec.span("inner") as a:
            time.sleep(0.003)
        with rec.span("inner") as b:
            with rec.span("leaf") as leaf:
                time.sleep(0.001)
    t = rec.totals(SETUP)["spans"]
    assert t["outer"]["parents"] == []
    assert t["inner"]["parents"] == ["outer"]
    assert t["leaf"]["parents"] == ["inner"]
    assert t["inner"]["calls"] == 2 and t["outer"]["calls"] == 1
    assert t["outer"]["s"] == outer.seconds
    assert t["inner"]["s"] == pytest.approx(a.seconds + b.seconds,
                                            rel=1e-12)
    # a span's self time leaves out its children, not its grandchildren
    assert outer.child_ns == a.ns + b.ns
    assert t["outer"]["self_s"] == pytest.approx(
        (outer.ns - a.ns - b.ns) / 1e9, rel=1e-12)
    assert t["inner"]["self_s"] == pytest.approx(
        (a.ns + b.ns - leaf.ns) / 1e9, rel=1e-12)
    assert t["outer"]["self_s"] >= 0.002
    assert b.parent == "outer" and leaf.parent == "inner"


def test_threads_add_exact_totals():
    """4 threads x 1,000 spans and counts, with a short switch interval:
    no update is lost, and each thread's spans nest on its own stack."""
    rec = Recorder()
    n_threads, n = 4, 1000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with rec.span("worker"):
                    with rec.span("worker.inner"):
                        pass
                rec.count("worker.n", 2)
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    t = rec.totals(SETUP)
    assert t["spans"]["worker"]["calls"] == n_threads * n
    assert t["spans"]["worker.inner"]["calls"] == n_threads * n
    assert t["spans"]["worker"]["parents"] == []
    assert t["spans"]["worker.inner"]["parents"] == ["worker"]
    assert t["counts"]["worker.n"] == 2 * n_threads * n
    assert rec.total("worker", [SETUP], "calls") == n_threads * n


def test_epoch_keys_and_setup_key():
    rec = Recorder()
    with rec.span("a"):
        pass
    rec.count("c", 3)
    rec.epoch = 0
    with rec.span("a"):
        pass
    rec.epoch = 1
    rec.count("c", 5)
    rec.count("c", 0.5)
    assert rec.epochs() == [0, 1, SETUP]
    assert rec.total("a", [SETUP], "calls") == 1
    assert rec.total("a", [0, 1], "calls") == 1
    assert rec.total("a", [1]) is None
    assert rec.total("c", [1], "count") == 5.5
    assert rec.total("c", [0, 1, SETUP], "count") == 8.5
    assert rec.total("c", [0], "count") is None
    assert rec.totals(1) == {"spans": {}, "counts": {"c": 5.5}}
    rec.reset()
    assert rec.epochs() == [] and rec.epoch == SETUP


def test_spans_reach_the_profiler_only_while_it_records(monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    opened = []
    real = timing._profiler.record_function

    def counted(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(timing._profiler, "record_function", counted)
    rec = Recorder()
    with rec.span("outside.before"):
        torch.ones(2).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("inside.outer"):
            with rec.span("inside.inner"):
                torch.ones(2).sum()
    with rec.span("outside.after"):
        torch.ones(2).sum()
    names = {e.name for e in prof.events()}
    assert {"inside.outer", "inside.inner"} <= names
    assert not {"outside.before", "outside.after"} & names
    assert opened == ["inside.outer", "inside.inner"]
    assert rec.total("outside.after", [SETUP], "calls") == 1


# --- the port's spans ------------------------------------------------

@pytest.mark.parametrize("group", [1, 2])
def test_epoch_spans_and_buckets(graph, fresh, group):
    """A tiny eager epoch and a grouped one (G = 2): the pipeline's and
    the sampler's spans, the re-padding on the grouped one, and each
    bucket the sum of its spans' clock reads."""
    tr = _trainer(graph, group)
    try:
        m = tr.train_epoch(graph.train_nodes, 0)
    finally:
        tr.pipeline.close()
    s = _spans(0)
    steps = len(m.step_losses)
    assert steps == -(-len(graph.train_nodes) // 64)
    assert {"train.epoch", "pipeline.next", "pipeline.wait",
            "train.to_device", "train.step"} <= set(s)
    assert s["pipeline.wait"]["parents"] == ["pipeline.next"]
    assert s["pipeline.next"]["parents"] == ["train.epoch"]
    # this epoch's batches, sampled by the pool
    assert RECORDER.total("sampler.batch", [SETUP, 0], "calls") >= steps
    assert RECORDER.total("sampler.batches", [SETUP, 0],
                          "count") >= steps
    assert RECORDER.total("sampler.draw", [SETUP, 0], "calls") >= 2 * steps
    assert s["train.step"]["calls"] == steps
    assert s["train.to_device"]["calls"] == steps
    if group == 1:
        assert "pipeline.repad" not in s
        assert s["pipeline.next"]["calls"] == steps + 1
        exec_s = s["train.step"]["s"]
    else:
        n_groups = -(-steps // group)
        assert s["pipeline.repad"]["calls"] == n_groups
        assert s["pipeline.repad"]["parents"] == ["pipeline.next"]
        assert s["pipeline.next"]["calls"] == n_groups + 1
        assert RECORDER.totals(0)["counts"]["pipeline.repad_bytes"] >= 0
        # the epoch-end loss read
        assert s["dispatch.card_wait"]["calls"] == 1
        exec_s = s["train.step"]["s"] + s["dispatch.card_wait"]["s"]
    assert m.sample_wait_time == pytest.approx(s["pipeline.next"]["s"],
                                               rel=1e-12)
    assert m.data_movement_time == pytest.approx(
        s["train.to_device"]["s"], rel=1e-12)
    assert m.execution_time == pytest.approx(exec_s, rel=1e-12)
    assert m.total_time == s["train.epoch"]["s"]
    assert len(m.step_times) == steps and min(m.step_times) > 0


def test_fit_records_val_and_checkpoint_each_epoch(graph, fresh, tmp_path):
    """Two epochs of ``fit``: one ``eval.val`` (its batch drawn, the
    forward, the F1) and one ``checkpoint.save`` an epoch; each epoch's
    ``metrics.jsonl`` record and `EpochMetrics` carry its spans and
    counts."""
    tr = _trainer(graph)
    metrics = MetricsRegistry(str(tmp_path / "metrics.jsonl"))
    try:
        hist = tr.fit(graph.train_nodes, graph.valid_nodes, 2, log=False,
                      checkpoint_dir=str(tmp_path / "ck"), metrics=metrics)
    finally:
        tr.pipeline.close()
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["epoch"] for r in recs] == [0, 1]
    for epoch, m, r in zip((0, 1), hist, recs):
        s = _spans(epoch)
        assert s["eval.val"]["calls"] == 1
        assert s["checkpoint.save"]["calls"] == 1
        for child in ("eval.sample", "eval.forward", "eval.f1"):
            assert s[child]["parents"] == ["eval.val"], child
        # the val batch is drawn on the main thread
        assert "eval.sample" in s["sampler.batch"]["parents"]
        assert r["spans"] == m.spans and r["counts"] == m.counts
        assert r["spans"]["checkpoint.save"]["calls"] == 1
        assert r["spans"]["train.step"]["calls"] == len(m.step_losses)
        assert r["spans"]["pipeline.next"]["s"] == pytest.approx(
            r["sample_wait_s"], rel=1e-12)
        assert r["counts"]["sampler.batches"] >= 1
    # the first epoch's val F1 beats the initial watermark
    assert _spans(0)["fit.best_copy"]["calls"] == 1


def test_cli_setup_records_its_steps(fresh, tmp_path):
    from gnn_tpu_torch import cli
    args = cli.build_parser().parse_args([
        "--device", "cpu", "--dataset",
        "synthetic:nodes=800,deg=8,feats=8,classes=3", "--hot_k", "64",
        "--save_dir", str(tmp_path)])
    cli._setup(args, (1, 1), 1, torch.device("cpu"), lambda *m: None)
    s = _spans(SETUP)
    assert s["setup.cli"]["calls"] == 1
    for name in ("setup.load", "setup.laplacian", "setup.placement",
                 "setup.sample_prob", "setup.hot_block",
                 "setup.resident_graph"):
        assert s[name]["parents"] == ["setup.cli"], name
    assert s["setup.cli"]["s"] >= sum(
        s[n]["s"] for n in s if n != "setup.cli")


def test_trainer_setup_spans(graph, fresh):
    from gnn_tpu_torch.parallel.feature_cache import ReplicatedFeatures
    ReplicatedFeatures(np.zeros((4, 3), np.float32))
    tr = _trainer(graph)
    tr.pipeline.close()
    s = _spans(SETUP)
    assert s["setup.features"]["calls"] == 2
    assert s["setup.trainer"]["calls"] == 1
    assert s["setup.features"]["parents"] == ["setup.trainer"]
