"""Training on the port's ``data x part`` grid of ranks
(``--resident_parts``: gnn_tpu_torch.parallel.dist's grid groups, the
sharded resident graph inside the forward and backward passes, the
part-sharded feature sources, the grid's gradient sum, eval, resume, op
timing, the CLI) against the JAX package's ``(data, part)`` mesh.

Port ranks are gloo processes on the CPU, started with ``spawn_ranks``
from `tests/torch_parts_worker.py` (which loads no JAX), one spawn per
configuration shared by the tests through module-scoped fixtures. The
JAX package runs on the eight virtual CPU devices. Training agrees
within 1e-5 (float32 sums in another order, over Adam steps, dropout off
and the same initial weights); every rank of a grid holds bitwise the
same parameters. This module imports JAX only inside its tests and
fixtures, so ``pytest --noconftest -m cuda`` runs its card test where
JAX is absent."""
import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

import torch_dist_worker as dw
import torch_parts_worker as pw
from gnn_tpu_torch.parallel import dist as tdist

TRAIN_TOL = dict(rtol=1e-5, atol=1e-5)
# GAT's outputs and gradients against the JAX layer (tests/test_torch_gat.py)
OUT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
TINY = ["--dataset", "synthetic:nodes=1200,deg=10,feats=16,classes=5",
        "--nhid", "16", "--orders", "1,1", "--samp_num", "128",
        "--batch_size", "64", "--epoch_num", "2", "--hot_k", "256",
        "--pool_num", "2", "--device", "cpu"]


def spawn(n, fn, args, out_dir):
    saved = tdist.JOIN_TIMEOUT_S, tdist.COLLECTIVE_TIMEOUT_S
    tdist.JOIN_TIMEOUT_S, tdist.COLLECTIVE_TIMEOUT_S = 300.0, 120.0
    try:
        tdist.spawn_ranks(n, fn, (str(out_dir),) + tuple(args),
                          rendezvous_dir=str(out_dir))
    finally:
        tdist.JOIN_TIMEOUT_S, tdist.COLLECTIVE_TIMEOUT_S = saved


def _jax_grid_trainer(g, monkeypatch, dp, parts):
    """The JAX Trainer on a ``(dp, parts)`` mesh of the virtual devices
    at the workers' configuration, the resident state and the feature
    table sharded over ``part``, every step's mean loss recorded in
    ``jtr.step_losses``."""
    import jax
    from jax.sharding import Mesh

    from gnn_tpu.models.gnn import build_model as jbuild
    from gnn_tpu.ops.hotdense import HotSpec, build_hot_dense
    from gnn_tpu.ops.residentgraph import build_resident_graph
    from gnn_tpu.parallel.feature_cache import PartShardedFeatures
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
    pipe = BatchPipeline(cfg, lap, g.labels, world_size=dp,
                         pool_num=dw.POOL, seed=dw.SEED)
    mesh = Mesh(np.asarray(jax.devices()[:dp * parts]).reshape(dp, parts),
                ("data", "part"))
    jtr = Trainer(jbuild("graphsage", dw.NHID, dw.SAMPLER["orders"],
                         g.num_classes, dropout=0.0), pipe, g.feats,
                  mesh=mesh, lr=0.01, sigmoid_loss=True, seed=dw.SEED,
                  feature_source=PartShardedFeatures(g.feats, parts),
                  resident_graph=build_resident_graph(lap, spec, d, dt),
                  resident_parts=parts)
    jtr.step_losses = []
    step = jtr.fns.train_step

    def recorded(*a):
        params, opt_state, loss = step(*a)
        jtr.step_losses.append(float(loss))
        return params, opt_state, loss
    jtr.fns = dataclasses.replace(jtr.fns, train_step=recorded)
    return jtr


def _jax_epoch(g, dp, parts, targets):
    """The port's initial weights (from the JAX init) and the JAX mesh's
    epoch: step losses, final parameters and Adam's first moments."""
    import jax

    from gnn_tpu_torch.weights import params_from_flax
    from tests.test_torch_dist import _init
    mp = pytest.MonkeyPatch()
    try:
        jtr = _jax_grid_trainer(g, mp, dp, parts)
        init = _init(jtr, targets)
        jtr.train_epoch(targets, 0)
        host = jax.tree_util.tree_map(np.asarray, jtr.params)
        mu = jax.tree_util.tree_map(np.asarray, jtr.opt_state[0].mu)
        jtr.close()
    finally:
        mp.undo()
    return init, dict(losses=jtr.step_losses, params=params_from_flax(host),
                      mu=params_from_flax(mu))


TARGETS = 384      # six steps of 64 on one data rank, three on each of two


def _gat_cases(g):
    """GAT's layer-0 cases, each built by both packages from one sampled
    batch: the lite COO cold residual, stream tiles (K3/K4's payload) and
    full expansion (a partial cold COO a part). Returns the cases the
    workers get and, per case, the JAX replicated layer's output and
    gradients and the port's replicated layer's."""
    import jax
    import jax.numpy as jnp

    from gnn_tpu.models import gat as jgat
    from gnn_tpu.ops import hotdense as jhd
    from gnn_tpu.ops import residentgraph as jrg
    from gnn_tpu.placement.engine import compute_sample_prob
    from gnn_tpu.sampling import ladies as jlad
    from gnn_tpu.utils.normalize import build_laplacian
    from gnn_tpu_torch.models.gat import GATConv
    from gnn_tpu_torch.ops import hotdense as thd
    from gnn_tpu_torch.ops import residentgraph as trg
    from gnn_tpu_torch.ops.sparse import to_device
    from gnn_tpu_torch.sampling import ladies as tlad
    from gnn_tpu_torch.weights import params_from_flax
    from tests.test_torch_parts import same_sampler_width

    same_sampler_width()
    lap = build_laplacian(g.adj_full, "graphsage")
    prob = compute_sample_prob(lap, g.train_nodes, 2)
    jspec = jhd.HotSpec.from_sample_prob(prob, 256)
    d, dt = jhd.build_hot_dense(lap, jspec, np.float32)
    jhost = jrg.build_resident_graph(lap, jspec, d, dt)
    jhost.pop("val_free")
    n, k, ct = jhost.pop("n"), jhost.pop("k"), jhost.pop("col_trivial")
    jg = jrg.ResidentGraph(**{f: jnp.asarray(v) for f, v in jhost.items()},
                           n=n, k=k, col_trivial=ct)
    tspec = thd.HotSpec.from_sample_prob(prob, 256)
    td, tdt = thd.build_hot_dense(lap, tspec, torch.float32, "cpu")
    rg = trg.build_resident_graph(lap, tspec, td, tdt)
    table = trg.ResidentGraph.from_host(rg, "cpu")
    cases, want = {}, {}
    for name, ship_cold, stream in (("coo", True, False),
                                    ("stream", True, True),
                                    ("full", False, False)):
        kw = dict(batch_size=64, samp_num=128, orders=(1, 1),
                  num_nodes=n, num_classes=g.num_classes,
                  adj_format="resident", compress=False,
                  resident_ship_cold=ship_cold, resident_val_free=ship_cold,
                  resident_stream_tiles=stream)
        tgt = g.train_nodes[:64]
        jmb = jlad.ladies_sample(jlad.SamplerConfig(hot_spec=jspec, **kw), 7,
                                 tgt, lap, g.labels)
        tmb = tlad.ladies_sample(tlad.SamplerConfig(hot_spec=tspec, **kw), 7,
                                 tgt, lap, g.labels)
        np.testing.assert_array_equal(tmb.input_nodes, jmb.input_nodes)
        ja = jrg.materialize_adjs(
            jg, list(jmb.adjs), [jnp.asarray(s) for s in jmb.sampled_nodes],
            jnp.asarray(jmb.input_nodes))[0]
        x = np.random.default_rng(3).normal(size=(ja.ncols, 16)).astype(
            np.float32)
        n_rows = int(ja.n_valid_rows)
        samp = jnp.asarray(jmb.sampled_nodes[0])
        conv = jgat.GATConv(n_out=32, n_heads=2)
        variables = conv.init(jax.random.PRNGKey(0), jnp.asarray(x), ja,
                              samp)

        def loss(v_, conv=conv, ja=ja, x=x, samp=samp, n_rows=n_rows):
            return jnp.sum(conv.apply(v_, jnp.asarray(x), ja,
                                      samp)[:n_rows] ** 2)
        weights = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                          variables))
        jout = np.asarray(conv.apply(variables, jnp.asarray(x), ja, samp))
        jgrads = params_from_flax(jax.tree_util.tree_map(
            np.asarray, jax.grad(loss)(variables)))
        ta = trg.materialize_adjs(
            table, [to_device(a, "cpu") for a in tmb.adjs],
            [torch.from_numpy(s) for s in tmb.sampled_nodes],
            torch.from_numpy(tmb.input_nodes))[0]
        tconv = GATConv(16, 32, n_heads=2)
        tconv.load_state_dict(weights)
        tout = tconv(torch.from_numpy(x), ta,
                     torch.from_numpy(tmb.sampled_nodes[0]))
        (tout[:n_rows] ** 2).sum().backward()
        cases[name] = dict(rg=rg, mb=tmb, x=x, n_out=32, heads=2,
                           weights=weights, full=not ship_cold)
        want[name] = dict(
            n_rows=n_rows, jax=(jout, jgrads),
            port=(tout.detach().numpy(),
                  {k: p.grad.numpy() for k, p in tconv.named_parameters()}))
    return cases, want


def _one_rank_trainer(init):
    """The workers' configuration on one replicated rank."""
    from gnn_tpu_torch.models.gnn import build_model
    from gnn_tpu_torch.sampling.pipeline import BatchPipeline
    from gnn_tpu_torch.train.trainer import Trainer
    b = dw.build()
    g = b["graph"]
    net = build_model("graphsage", dw.NHID, dw.SAMPLER["orders"],
                      g.num_classes, n_feats=g.feats.shape[1], dropout=0.0)
    net.load_state_dict(init)
    pipe = BatchPipeline(b["cfg"], b["lap"], g.labels, pool_num=dw.POOL,
                         seed=dw.SEED)
    return Trainer(net, pipe, g.feats, lr=0.01, sigmoid_loss=True,
                   seed=dw.SEED, resident_graph=b["rg"], device="cpu")


@pytest.fixture(scope="module")
def part_runs(small_graph, tmp_path_factory):
    """One data rank x two part ranks: the JAX ``(1, 2)`` mesh's epoch;
    the port's epoch with node-range feature shards and with the
    composed cache (``grid_case``); the first-batch gradient, GAT's
    sharded attention, a resume and the op-timing buckets
    (``part_case``); and the same epoch on one replicated rank."""
    targets = small_graph.train_nodes[:TARGETS]
    init, jax_run = _jax_epoch(small_graph, 1, 2, targets)
    out = tmp_path_factory.mktemp("parts")
    spawn(2, pw.grid_case, (2, init, targets, ("sharded", "cached")), out)
    cases, gat_want = _gat_cases(small_graph)
    spawn(2, pw.part_case, (init, targets, cases), out)
    tr = _one_rank_trainer(init)
    try:
        grads, _ = dw.first_grads(tr, targets, None)
        m = tr.train_epoch(targets, 0)
    finally:
        tr.pipeline.close()
    return dict(
        jax=jax_run, gat_want=gat_want, rep_losses=np.asarray(m.step_losses),
        rep_grads={k: v.numpy() for k, v in grads.items()},
        grid=[dict(np.load(out / f"grid{r}.npz")) for r in range(2)],
        part=[dict(np.load(out / f"part{r}.npz")) for r in range(2)])


@pytest.fixture(scope="module")
def grid22_runs(small_graph, tmp_path_factory):
    """Two data ranks x two part ranks (four gloo ranks) against the JAX
    ``(2, 2)`` mesh."""
    targets = small_graph.train_nodes[:TARGETS]
    init, jax_run = _jax_epoch(small_graph, 2, 2, targets)
    out = tmp_path_factory.mktemp("grid22")
    spawn(4, pw.grid_case, (2, init, targets, ("sharded",)), out)
    return dict(jax=jax_run,
                grid=[dict(np.load(out / f"grid{r}.npz")) for r in range(4)])


def _keyed(rec, prefix):
    return {k[len(prefix):]: v for k, v in rec.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("grid", ["1x2", "2x2"])
def test_grid_training_matches_jax_mesh(part_runs, grid22_runs, grid):
    """One epoch of the port's grid against the JAX Trainer on the
    ``(data, part)`` mesh, from the same weights: every step's mean loss,
    the parameters and Adam's first moments within 1e-5; every rank holds
    bitwise the same parameters and logs the same losses, and reduced
    bytes over its part group."""
    run = part_runs if grid == "1x2" else grid22_runs
    recs, want = run["grid"], run["jax"]
    losses = recs[0]["sharded_losses"]
    assert len(losses) == len(want["losses"]) == {"1x2": 6, "2x2": 3}[grid]
    np.testing.assert_allclose(losses, want["losses"], **TRAIN_TOL)
    for rec in recs:
        assert str(rec["sharded_digest"]) == str(recs[0]["sharded_digest"])
        np.testing.assert_array_equal(rec["sharded_losses"], losses)
        assert int(rec["sharded_part_bytes"]) > 0
    for what in ("param", "mu"):
        got = _keyed(recs[0], f"sharded_{what}_")
        ref = want["params" if what == "param" else "mu"]
        assert got.keys() == ref.keys()
        for k, v in ref.items():
            np.testing.assert_allclose(got[k], v.numpy(), err_msg=k,
                                       **TRAIN_TOL)


def test_composed_cache_matches_the_replicated_run(part_runs):
    """``--resident_parts --feature_cache``: the epoch with the placement's
    buffers one a part matches the node-range shards' bit for bit (the
    gathers are exact) and one replicated rank's within 1e-5."""
    rec = part_runs["grid"]
    np.testing.assert_array_equal(rec[0]["cached_losses"],
                                  rec[0]["sharded_losses"])
    assert str(rec[0]["cached_digest"]) == str(rec[1]["cached_digest"]) \
        == str(rec[0]["sharded_digest"])
    np.testing.assert_allclose(rec[0]["cached_losses"],
                               part_runs["rep_losses"], **TRAIN_TOL)


def test_part_gradients_are_the_whole_gradient(part_runs):
    """Each part rank's gradient on its first batch, before the clip, is
    the one-rank gradient: the hot products' sums inside the forward and
    the transposed products give every part the whole gradient, neither
    a part's share nor P times it."""
    want = part_runs["rep_grads"]
    for rec in part_runs["part"]:
        got = _keyed(rec, "grad_")
        assert got.keys() == want.keys()
        num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
        den = sum(float(np.sum(want[k] ** 2)) for k in want)
        assert math.sqrt(num / den) < 1e-5


@pytest.mark.parametrize("case", ["coo", "stream", "full"])
def test_sharded_gat_attention_matches(part_runs, case):
    """GAT's part-sharded hot attention (lite COO cold residual, stream
    tiles, and full expansion's partial cold COO): each part's output and
    parameter gradients equal the port's replicated layer's within 1e-5
    (gradients: 1e-4 relative, or 1e-5 of the largest gradient entry,
    since ``k.bias``'s gradient is zero up to rounding: a row's softmax
    does not see a shift by ``q . b``) and the JAX replicated layer's
    within GAT's tolerances."""
    want = part_runs["gat_want"][case]
    n_rows = want["n_rows"]
    pout, pgrads = want["port"]
    jout, jgrads = want["jax"]
    for rec in part_runs["part"]:
        out = rec[f"gat_{case}_out"]
        grads = _keyed(rec, f"gat_{case}_grad_")
        assert int(rec[f"gat_{case}_bytes"]) > 0
        np.testing.assert_allclose(out[:n_rows], pout[:n_rows], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out[:n_rows], jout[:n_rows], **OUT_TOL)
        assert grads.keys() == pgrads.keys()
        scale = max(float(np.abs(v).max()) for v in pgrads.values())
        for k, v in grads.items():
            np.testing.assert_allclose(v, pgrads[k], rtol=1e-4,
                                       atol=1e-5 * scale, err_msg=k)
            np.testing.assert_allclose(v, jgrads[k].numpy(), err_msg=k,
                                       **GRAD_TOL)


def test_resume_replays_the_loss_curve(part_runs):
    """Two part ranks: one epoch, then a resume to three, trains epochs 1
    and 2 with the uninterrupted run's step losses."""
    for rec in part_runs["part"]:
        assert rec["resume_epochs"].tolist() == [1, 2]
        np.testing.assert_allclose(rec["resume_losses"], rec["full_losses"],
                                   rtol=1e-6, atol=0)


def test_op_timing_part_branch(part_runs):
    for rec in part_runs["part"]:
        fwd, bwd, comm = rec["op_buckets"]
        assert all(math.isfinite(v) and v > 0 for v in (fwd, bwd, comm))


def _records(save, n):
    ranks = []
    for r in range(n):
        with open(save / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    with open(save / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if "step_losses" in r], recs, ranks


@pytest.mark.parametrize("flags,world", [
    (["--n_devices", "1", "--resident_parts", "2"], 2),
    (["--n_devices", "1", "--resident_parts", "2", "--feature_cache"], 2),
    (["--n_devices", "2", "--resident_parts", "2", "--feature_cache",
      "--locality_sampling"], 4)])
def test_cli_trains_the_grid_on_cpu(tmp_path, flags, world):
    """``main`` trains the grid: rank 0 writes the one metrics.jsonl (the
    test F1 too), every rank its record with the same parameter digests,
    bytes summed over its part group, and a part's share of the resident
    state (the bfloat16 blocks' columns) and of the features."""
    from gnn_tpu_torch import cli as tcli
    save = tmp_path / "save"
    saved = tdist.JOIN_TIMEOUT_S, tdist.COLLECTIVE_TIMEOUT_S
    tdist.JOIN_TIMEOUT_S, tdist.COLLECTIVE_TIMEOUT_S = 300.0, 120.0
    try:
        assert tcli.main(TINY + flags + ["--test", "--save_dir",
                                         str(save)]) == 0
    finally:
        tdist.JOIN_TIMEOUT_S, tdist.COLLECTIVE_TIMEOUT_S = saved
    eps, recs, ranks = _records(save, world)
    assert [r["epoch"] for r in eps] == [0, 1]
    assert all(math.isfinite(v) for r in eps for v in r["step_losses"])
    assert 0.0 <= recs[-1]["test_f1"] <= 1.0
    digests = [[e["param_digest"] for e in r["epochs"]] for r in ranks]
    assert all(d == digests[0] for d in digests)
    assert len(set(digests[0])) == 2
    for r, rec in enumerate(ranks):
        assert (rec["data_rank"], rec["part_rank"]) == divmod(r, 2)
        assert all(e["part_bytes"] > 0 for e in rec["epochs"])
        sb = rec["state_bytes"]
        assert sb["dense"] == sb["dense_t"] == 256 * 128 * 2
        assert "csr" not in sb
    assert not [f for f in os.listdir(save) if f.startswith(".rendezvous")]


@pytest.mark.parametrize("flags,match", [
    (["--n_devices", "1", "--resident_parts", "2", "--adj_format", "hot"],
     "--resident_parts needs --adj_format resident"),
    (["--resident_parts", "2"], "give the data ranks with --n_devices")])
def test_cli_refuses_what_the_grid_cannot_run(tmp_path, flags, match):
    from gnn_tpu_torch import cli as tcli
    with pytest.raises(SystemExit, match=match):
        tcli.main(TINY + flags + ["--save_dir", str(tmp_path)])


@pytest.mark.cuda
def test_cuda_two_part_ranks_share_the_card(tmp_path):
    """Two gloo part ranks on ``cuda:0`` in composed mode: the gather is
    the table's rows exactly, and both ranks end an epoch with the same
    parameters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b = dw.build()
    from gnn_tpu_torch.models.gnn import build_model
    g = b["graph"]
    init = build_model("graphsage", dw.NHID, dw.SAMPLER["orders"],
                       g.num_classes, n_feats=g.feats.shape[1],
                       dropout=0.0, seed=0).state_dict()
    spawn(2, pw.cuda_case, (init,), tmp_path)
    recs = []
    for r in range(2):
        with open(tmp_path / f"cuda{r}.json") as f:
            recs.append(json.load(f))
    assert [r["device"] for r in recs] == ["cuda:0", "cuda:0"]
    assert all(r["gather_exact"] for r in recs)
    assert recs[0]["digest"] == recs[1]["digest"]
    assert all(math.isfinite(v) for v in recs[0]["losses"])
