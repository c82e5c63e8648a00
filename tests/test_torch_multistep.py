"""Grouped dispatch (``steps_per_dispatch`` G): the port against the JAX
package's ``train_epoch_grouped`` / ``Trainer(steps_per_dispatch=G)`` and
against itself at G = 1.

The configuration of `tests/test_torch_train.py`: ``small_graph``,
orders (1, 1), nhid 32, samp_num 128, batch 64, hot_k 256, dropout 0,
the flax weights carried across by `params_from_flax`, ``pool_num`` 2
and both native samplers at one OpenMP width. The cases (:data:`CASES`):
GraphSAGE on the resident path with stream tiles (val-free), on the hot
format (host-packed layers, the hot blocks bound on the device) and on
the coo format, and GAT on the resident path (its cold residual through
K3/K4: the port's plain versions here, the Pallas kernels in interpret
mode on the JAX side). The targets make 6 steps an epoch, so G = 4 runs
one full group and a tail of 2. Tolerances: against JAX rtol 1e-4 /
atol 1e-5 (`tests/test_torch_train.py`'s: float32 sums in another order
over Adam steps); the port at G = 4 against G = 1 1e-6 (the same steps
on re-padded batches: the padding adds zero terms and unread rows). The
card's test holds one graph replay against eager steps, dropout on, with
every loss within 1e-5 relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

from gnn_tpu_torch.models.gnn import build_model as tbuild
from gnn_tpu_torch.ops.hotdense import HotSpec as THotSpec
from gnn_tpu_torch.ops.hotdense import build_hot_dense as tbuild_hd
from gnn_tpu_torch.ops.residentgraph import build_resident_graph as \
    tbuild_rg
from gnn_tpu_torch.placement.engine import compute_sample_prob
from gnn_tpu_torch.sampling.ladies import SamplerConfig as TCfg
from gnn_tpu_torch.sampling.pipeline import BatchPipeline as TPipe
from gnn_tpu_torch.train.dispatch import (_adj_leaves, batch_leaves,
                                           group_key)
from gnn_tpu_torch.train.stepfns import prepare_adjs, to_device_batch
from gnn_tpu_torch.train.trainer import Trainer as TTrainer
from gnn_tpu_torch.utils.normalize import build_laplacian
from torch_sampler_width import port_sampler_width, same_sampler_width

G = 4
STEPS = 6
ORDERS = (1, 1)
# (model, adjacency format) of the grouped cases
CASES = [("graphsage", "resident"), ("graphsage", "hot"),
         ("graphsage", "coo"), ("gat", "resident")]
FORMATS = ["resident", "hot", "coo"]
# the card's test: each graph's step count, in capture order over its two
# epochs, with the samplers at width 2: [G, 1] (the full group's graph,
# then the tail's), but on coo the second epoch's groups need a larger
# edge bucket than the first epoch's caps, so the book grows once and
# both graphs are captured again for the new shapes
CAPTURES = {("graphsage", "coo"): [G, 1, G, 1]}


class Setup:
    """The port's sampler configuration and its resident graph (resident
    format) or hot blocks (hot format) on ``g`` (``small_graph``) for
    ``model``, the targets (``STEPS`` batches) and the initial weights
    (``init``: the flax model's, carried across, unless a test sets its
    own); :meth:`jax_side` builds the JAX package's."""

    def __init__(self, g, stream_tiles=True, model="graphsage",
                 adj_format="resident"):
        self.g = g
        self.model = model
        self.lap = build_laplacian(g.adj_full, model)
        self.prob = compute_sample_prob(self.lap, g.train_nodes,
                                        sum(ORDERS))
        self.kw = dict(batch_size=64, samp_num=128, orders=ORDERS,
                       num_nodes=self.lap.shape[0],
                       num_classes=g.num_classes, adj_format=adj_format)
        self.trg = self.thot = None
        if adj_format == "resident":
            self.kw.update(resident_val_free=True,
                           resident_stream_tiles=stream_tiles)
        if adj_format in ("hot", "resident"):
            tspec = THotSpec.from_sample_prob(self.prob, 256)
            td, tdt = tbuild_hd(self.lap, tspec, torch.float32, "cpu")
            self.tcfg = TCfg(hot_spec=tspec, **self.kw)
            if adj_format == "resident":
                self.trg = tbuild_rg(self.lap, tspec, td, tdt)
            else:
                self.thot = (td, tdt)
        else:
            self.tcfg = TCfg(**self.kw)
        self.targets = g.train_nodes[: 64 * STEPS]
        self.init = None

    def jax_side(self):
        """The JAX package's sampler configuration and its resident graph
        and hot blocks (each None where the format has none)."""
        from gnn_tpu.ops.hotdense import HotSpec, build_hot_dense
        from gnn_tpu.ops.residentgraph import build_resident_graph
        from gnn_tpu.sampling.ladies import SamplerConfig
        fmt = self.kw["adj_format"]
        if fmt not in ("hot", "resident"):
            return SamplerConfig(**self.kw), None, None
        spec = HotSpec.from_sample_prob(self.prob, 256)
        d, dt = build_hot_dense(self.lap, spec, np.float32)
        cfg = SamplerConfig(hot_spec=spec, **self.kw)
        if fmt == "hot":
            return cfg, None, (d, dt)
        return cfg, build_resident_graph(self.lap, spec, d, dt), None

    def jpipe(self, cfg=None):
        from gnn_tpu.sampling.pipeline import BatchPipeline
        return BatchPipeline(cfg or self.jax_side()[0], self.lap,
                             self.g.labels, world_size=1, pool_num=2,
                             seed=3)

    def tpipe(self):
        return TPipe(self.tcfg, self.lap, self.g.labels, pool_num=2, seed=3)

    def jtrainer(self, spd):
        """The JAX Trainer at ``spd`` steps a dispatch, dropout 0; its
        initial parameters become :attr:`init`."""
        import jax

        from gnn_tpu.models.gnn import build_model
        from gnn_tpu.parallel.mesh import make_mesh
        from gnn_tpu.train.trainer import Trainer
        from gnn_tpu_torch.weights import params_from_flax
        cfg, rg, hot = self.jax_side()
        jtr = Trainer(build_model(self.model, 32, ORDERS,
                                  self.g.num_classes, dropout=0.0),
                      self.jpipe(cfg), self.g.feats, mesh=make_mesh(1),
                      lr=0.01, sigmoid_loss=True, seed=3, resident_graph=rg,
                      hot_dense=hot, steps_per_dispatch=spd)
        jtr._init_params(jtr._peek_batch(self.targets))
        self.init = params_from_flax(
            jax.tree_util.tree_map(np.asarray, jtr.params))
        return jtr

    def ttrainer(self, spd, dropout=0.0, device="cpu"):
        if self.init is None:
            self.jtrainer(1).close()
        net = tbuild(self.model, 32, ORDERS, self.g.num_classes,
                     n_feats=self.g.feats.shape[1], dropout=dropout)
        net.load_state_dict(self.init)
        return TTrainer(net, self.tpipe(), self.g.feats, lr=0.01,
                        sigmoid_loss=True, seed=3, resident_graph=self.trg,
                        hot_dense=self.thot, device=device,
                        steps_per_dispatch=spd)


@pytest.fixture(scope="module", params=CASES,
                ids=["-".join(c) for c in CASES])
def case(request, small_graph):
    """The :class:`Setup` of a ``(model, format)`` pair: each of
    :data:`CASES`, or the pairs a test names by indirect
    parametrisation."""
    return Setup(small_graph, model=request.param[0],
                 adj_format=request.param[1])


def _arrays(mb):
    """Every array of a host batch by name (adjacency fields as
    ``adj{l}.{field}``)."""
    out = {f: getattr(mb, f) for f in ("input_nodes", "input_mask",
                                        "labels", "label_mask",
                                        "batch_nodes")}
    out.update({f"sampled{l}": s for l, s in enumerate(mb.sampled_nodes)})
    for l, a in enumerate(mb.adjs):
        for f in dataclasses.fields(a):
            out[f"adj{l}.{f.name}"] = getattr(a, f.name)
    return out


@pytest.mark.parametrize("case", [("graphsage", f) for f in FORMATS],
                         ids=FORMATS, indirect=True)
def test_grouped_host_arrays_match_jax(case):
    """Two epochs of groups: the port's re-padded batches equal the JAX
    pipeline's ``[G, 1, ...]`` stacks bit for bit, shapes, dtypes and
    counts included, and the tail group repeats its last batch. Before
    the second epoch both shape books' caps are doubled (as when an
    earlier group grew them), so every layer of that epoch pads past
    its own size: the edges, and a hot layer's batch-present slots."""
    setup = case
    jp, tp, raw_p = setup.jpipe(), setup.tpipe(), setup.tpipe()
    same_sampler_width()
    try:
        for epoch in range(2):
            if epoch == 1:
                caps = dict(tp.shape_book._caps)
                assert caps == jp.shape_book._caps
                for k, v in caps.items():
                    assert tp.shape_book.cap((k,), 2 * v) == \
                        jp.shape_book.cap((k,), 2 * v) == 2 * v
            jg = list(jp.train_epoch_grouped(setup.targets, epoch=epoch,
                                             group=G))
            tg = list(tp.train_epoch_grouped(setup.targets, epoch=epoch,
                                             group=G))
            assert [n for _, n in tg] == [n for _, n in jg] == [G, 2]
            if epoch == 1:
                raw = list(raw_p.train_epoch(setup.targets, epoch=epoch))
                for r, mb in zip(raw, [mb for mbs, n in tg
                                       for mb in mbs[:n]]):
                    for a, b in zip(r.adjs, mb.adjs):
                        assert ([x.shape for x in _adj_leaves(a, True)]
                                != [x.shape for x in _adj_leaves(b, True)])
            for (jmb, _), (tmbs, _) in zip(jg, tg):
                assert len(tmbs) == G
                assert len({group_key(mb) for mb in tmbs}) == 1
                for g, tmb in enumerate(tmbs):
                    for name, t in _arrays(tmb).items():
                        field = name.split(".")[-1]
                        j = (getattr(jmb.adjs[int(name[3])], field)
                             if name.startswith("adj") else
                             jmb.sampled_nodes[int(name[7:])]
                             if name.startswith("sampled")
                             else getattr(jmb, name))
                        if isinstance(t, np.ndarray):
                            jj = np.asarray(j)[g, 0]
                            if str(jj.dtype) == "bfloat16":
                                jj = jj.astype(np.float32)
                            assert t.dtype == jj.dtype, name
                            np.testing.assert_array_equal(t, jj, name)
                        elif j is None or isinstance(j, (int, bool)):
                            assert t == j, name
                        else:
                            assert t == int(np.asarray(j)[g, 0]), name
            tail = tg[-1][0]
            assert tail[2] is tail[3] or all(
                np.array_equal(a, b) for a, b in zip(
                    batch_leaves(tail[2], True), batch_leaves(tail[3], True)))
    finally:
        jp.pool.shutdown(wait=True)
        tp.close()
        raw_p.close()


def test_shape_book_persists_like_jax(tmp_path):
    """Caps only grow and persist on growth in the JAX book's file
    format (the JAX ``ShapeBook`` reads the port's file back); a book
    that cannot be read starts empty."""
    from gnn_tpu.sampling.pipeline import ShapeBook as JBook
    from gnn_tpu_torch.sampling.pipeline import ShapeBook
    path = str(tmp_path / "book.json")
    book = ShapeBook(path)
    key = (0, 2048, 10240, "ResidentLayerRef", "nnz")
    assert book.cap(key, 5000) == 5000
    assert book.cap(key, 4000) == 5000
    assert book.cap(key, 6000) == 6000
    assert ShapeBook(path).cap(key, 1) == 6000
    assert JBook(path).cap(key, 1) == 6000
    with open(path, "w") as f:
        f.write("[1, 2")
    assert ShapeBook(path).cap(key, 7) == 7


def _gradient_free(model: str, name: str) -> bool:
    """Whether a parameter's gradient is 0 in exact arithmetic: GAT's
    key biases, since a row's softmax does not change when every key
    moves by one vector. Adam divides each gradient by its running
    scale, so such a parameter follows the rounding of its gradient and
    the two packages' values part."""
    return model == "gat" and name.endswith(".k.bias")


def test_grouped_training_matches_jax(case):
    """The port at G = 4 against JAX's ``Trainer(steps_per_dispatch=4)``
    over two epochs, on each of :data:`CASES`: each epoch's loss, the val
    loss and F1 after them, and the final parameters (every one but the
    gradient-free ones, :func:`_gradient_free`). On the hot format the
    hot-block product and the cold ``index_add_`` sum in another order
    than XLA's, and over 12 Adam steps an element or two near 0 part by
    more than the elementwise 1e-5 (measured at G = 4 as at G = 1: one
    element of a ``linearB.weight`` by 1.55e-5 in layer 0, 1.29e-4 in
    layer 1), so there each tensor is held as a whole: its difference's
    norm within 1e-4 of its norm (measured at most 2.21e-5, layer 1's
    ``linearB.weight``; 7.7e-6 or less for every other tensor)."""
    setup = case
    jtr = setup.jtrainer(G)
    ttr = setup.ttrainer(G)
    same_sampler_width()
    try:
        jl = [jtr.train_epoch(setup.targets, epoch=e).train_loss
              for e in range(2)]
        tm = [ttr.train_epoch(setup.targets, epoch=e) for e in range(2)]
        assert [len(m.step_losses) for m in tm] == [STEPS, STEPS]
        np.testing.assert_allclose([m.train_loss for m in tm], jl,
                                   rtol=1e-4, atol=1e-5)
        jf1, jvl = jtr.evaluate(setup.g.valid_nodes, 128, "val")
        tf1, tvl = ttr.evaluate(setup.g.valid_nodes, 128, "val")
        assert tvl == pytest.approx(jvl, rel=1e-4, abs=1e-5)
        assert tf1 == pytest.approx(jf1, abs=1e-6)
        import jax

        from gnn_tpu_torch.weights import params_from_flax
        want = params_from_flax(
            jax.tree_util.tree_map(np.asarray, jtr.params))
        got = ttr.net.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            a, b = got[k].numpy(), want[k].numpy()
            if setup.kw["adj_format"] == "hot":
                assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), k
            elif not _gradient_free(setup.model, k):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                           err_msg=k)
        assert ttr.n_updates == 2 * STEPS
    finally:
        ttr.pipeline.close()
        jtr.close()


def _run(setup, spd, epochs=2):
    tr = setup.ttrainer(spd)
    same_sampler_width()
    try:
        ms = [tr.train_epoch(setup.targets, epoch=e) for e in range(epochs)]
    finally:
        tr.pipeline.close()
    return tr, ms


def test_grouped_matches_per_step(case):
    """G = 4 against G = 1 in the port, on each of :data:`CASES`: every
    step's loss and every parameter within 1e-6, the same update count,
    and a step time for every step."""
    setup = case
    t1, m1 = _run(setup, 1)
    t4, m4 = _run(setup, G)
    for a, b in zip(m1, m4):
        np.testing.assert_allclose(b.step_losses, a.step_losses, rtol=1e-6,
                                   atol=1e-6)
        assert len(b.step_times) == STEPS
    assert t4.n_updates == t1.n_updates == 2 * STEPS
    for (k, a), b in zip(t1.net.state_dict().items(),
                         t4.net.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("stream_tiles", [True, False])
def test_counts_ride_in_the_static_buffers(small_graph, stream_tiles):
    """Two batches of one group share padded shapes (one graph key) but
    not their counts (``n_valid_*``, and the lite COO's ``n_cold``).
    Copying the second batch's leaves into device buffers made from the
    first, as the card's staging does, gives the second batch's forward
    exactly: every value a step reads rides in a buffer, none is baked
    in as a Python int."""
    s = Setup(small_graph, stream_tiles=stream_tiles)
    tp = s.tpipe()
    same_sampler_width()
    try:
        (mbs, _), = [x for x in tp.train_epoch_grouped(
            s.targets[:64 * G], epoch=0, group=G)]
    finally:
        tp.close()
    fields = ["n_valid_rows", "n_valid_cols"] + (
        [] if stream_tiles else ["n_cold"])
    a, b = next((x, y) for i, x in enumerate(mbs) for y in mbs[i + 1:]
                if all(getattr(x.adjs[0], f) != getattr(y.adjs[0], f)
                       for f in fields))
    assert group_key(a) == group_key(b)
    net = tbuild("graphsage", 32, ORDERS, small_graph.num_classes,
                 n_feats=small_graph.feats.shape[1], dropout=0.0).eval()
    feats = torch.from_numpy(small_graph.feats)
    from gnn_tpu_torch.ops.residentgraph import ResidentGraph
    rg = ResidentGraph.from_host(s.trg, "cpu")

    def forward(batch):
        x = feats[batch.input_nodes.long()] * batch.input_mask[:, None]
        return net(x, prepare_adjs(batch, rg), batch.sampled_nodes)

    slot = to_device_batch(a, "cpu")
    for l in range(len(ORDERS)):
        for f in fields:
            assert isinstance(getattr(slot.adjs[l], f), torch.Tensor)
    with torch.no_grad():
        out_a = forward(slot)
        for d, x in zip(batch_leaves(slot, False), batch_leaves(b, True)):
            d.copy_(torch.as_tensor(x))
        out_slot = forward(slot)
        out_b = forward(to_device_batch(b, "cpu"))
    assert not torch.equal(out_a, out_b)
    assert torch.equal(out_slot, out_b)


def test_resume_across_group_sizes(small_graph, tmp_path):
    """A run checkpointed after epoch 0 at G = 4 resumes at G = 1 for
    epoch 1 to the parameters of an uninterrupted G = 1 run (1e-6), with
    the update count and Adam's step count carried (a CPU float32 step
    tensor, the eager layout)."""
    setup = Setup(small_graph)
    ref, _ = _run(setup, 1)
    a = setup.ttrainer(G)
    same_sampler_width()
    try:
        a.fit(setup.targets, setup.g.valid_nodes, epochs=1, log=False,
              checkpoint_dir=str(tmp_path))
    finally:
        a.pipeline.close()
    payload = torch.load(tmp_path / "latest_model.pt", weights_only=True)
    assert payload["n_updates"] == STEPS
    for st in payload["opt_state"]["state"].values():
        assert st["step"].device.type == "cpu"
        assert st["step"].dtype == torch.float32
        assert float(st["step"]) == STEPS
    assert not payload["opt_state"]["param_groups"][0]["capturable"]
    b = setup.ttrainer(1)
    same_sampler_width()
    try:
        hist = b.fit(setup.targets, setup.g.valid_nodes, epochs=2,
                     log=False, checkpoint_dir=str(tmp_path), resume=True)
    finally:
        b.pipeline.close()
    assert [m.epoch for m in hist] == [1]
    assert b.n_updates == ref.n_updates == 2 * STEPS
    for (k, x), y in zip(ref.net.state_dict().items(),
                         b.net.state_dict().values()):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_grouped_trainer_refuses_what_is_not_ported(small_graph):
    """G > 1 raises, naming the roadmap, for GAT on the pattern format,
    the blocked format, a feature source other than the replicated table
    (the one-rank cache) and two ranks; each of :data:`CASES` builds.
    The CLI asks the same function (`dispatch.unported`)."""
    from gnn_tpu_torch.parallel.dist import DistContext
    from gnn_tpu_torch.parallel.feature_cache import CachedFeatures
    from gnn_tpu_torch.placement.engine import create_placement
    from gnn_tpu_torch.train.dispatch import unported
    g = small_graph

    def trainer(model, adj_format, **kw):
        s = Setup(g, model=model, adj_format=adj_format)
        net = tbuild(model, 32, ORDERS, g.num_classes,
                     n_feats=g.feats.shape[1])
        tp = s.tpipe()
        try:
            return TTrainer(net, tp, g.feats, resident_graph=s.trg,
                            hot_dense=s.thot, device="cpu",
                            steps_per_dispatch=G, **kw)
        finally:
            tp.close()

    for model, adj_format in CASES:
        assert trainer(model, adj_format).steps_per_dispatch == G
    n = g.adj_full.shape[0]
    placement = create_placement(Setup(g).lap,
                                 g.train_nodes, per_dev=n // 5, num_devs=1,
                                 num_conv_layers=sum(ORDERS))
    refused = [
        (("gat", "pattern"), {}, "GAT on the pattern format"),
        (("gat", "coo"), {}, "GAT on the coo format"),
        (("graphsage", "blocked"), {}, "the blocked format"),
        (("graphsage", "resident"),
         dict(feature_source=CachedFeatures(g.feats, placement,
                                            DistContext())),
         "replicated table"),
        (("graphsage", "resident"), dict(dist=DistContext(world_size=2)),
         "2 ranks")]
    for (model, adj_format), kw, why in refused:
        with pytest.raises(NotImplementedError, match="ROADMAP.md") as e:
            trainer(model, adj_format, **kw)
        assert why in str(e.value), (model, adj_format, str(e.value))
    assert unported(adj_format="hot", attention=False, ranks=1,
                    replicated=True) == []
    assert unported(adj_format="hot", attention=True, ranks=2,
                    replicated=False) == [
        "2 ranks", "GAT on the hot format",
        "a feature source other than the replicated table"]


@pytest.mark.cuda
@pytest.mark.parametrize("model,adj_format", CASES,
                         ids=["-".join(c) for c in CASES])
def test_cuda_graph_replay_matches_eager_steps(tmp_path, model, adj_format):
    """On the card, dropout on, for each of :data:`CASES`: an epoch of
    G = 4 (one replay of a 4-step graph, the tail replaying the one-step
    graph twice) against the same epoch of eager steps from the same
    generator state; every step loss within 1e-5 relative, the captures
    exactly those of :data:`CAPTURES`, the replays covering every step,
    and the kernels of the path recorded and
    replayed: K1 in both directions on GraphSAGE's resident path, K3 and
    K4's three kernels and the hot part's mask pass and four dot modes
    twice a step (one a layer) on GAT's, none on the hot and coo
    formats. Then a checkpoint of the grouped run (a CPU
    float32 step count) resumes at G = 1. ``small_graph``'s graph from
    the port's own generator (no JAX on the card's machine)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    from gnn_tpu_torch.data.synthetic import make_powerlaw_graph
    g = make_powerlaw_graph(num_nodes=2000, avg_degree=12, num_feats=32,
                            num_classes=7, seed=0)
    s = Setup(g, model=model, adj_format=adj_format)
    s.init = tbuild(model, 32, ORDERS, g.num_classes,
                    n_feats=g.feats.shape[1]).state_dict()
    eager = s.ttrainer(1, dropout=0.1, device="cuda")
    grouped = s.ttrainer(G, dropout=0.1, device="cuda")
    port_sampler_width()
    try:
        for e in range(2):
            want = eager.train_epoch(s.targets, epoch=e).step_losses
            got = grouped.train_epoch(s.targets, epoch=e).step_losses
            np.testing.assert_allclose(got, want, rtol=1e-5)
        d = grouped._dispatch
        assert [c["steps"] for c in d.captures] == \
            CAPTURES.get((model, adj_format), [G, 1])
        assert sum(c["steps"] * c["replays"] for c in d.captures) == \
            2 * STEPS
        rep = d.replayed_launches()
        if model == "gat":
            # K3/K4, and the hot part on its live entries: the mask pass
            # and the four dot modes
            assert rep == {f"{mod}.{k}": len(ORDERS) * 2 * STEPS
                           for mod, keys in (
                               ("esattn", ("rowmax", "terms", "bwd_q",
                                           "bwd_kv")),
                               ("hotattn", ("mask", "dot_rowmax",
                                            "dot_terms", "dot_bwd_row",
                                            "dot_bwd_col")))
                           for k in keys}
        elif adj_format == "resident":
            assert rep["edgestream.forward"] >= 2 * len(ORDERS) * STEPS
            assert rep["edgestream.transpose"] >= \
                2 * (len(ORDERS) - 1) * STEPS
        else:
            assert not rep
        grouped.save(str(tmp_path), step=2)
    finally:
        eager.pipeline.close()
        grouped.pipeline.close()
    payload = torch.load(tmp_path / "latest_model.pt", weights_only=True)
    for st in payload["opt_state"]["state"].values():
        assert st["step"].device.type == "cpu"
        assert st["step"].dtype == torch.float32
    resumed = s.ttrainer(1, dropout=0.1, device="cuda")
    try:
        assert resumed.restore(str(tmp_path)) == 2
        assert resumed.n_updates == 2 * STEPS
        for a, b in zip(resumed.net.parameters(), grouped.net.parameters()):
            assert torch.equal(a, b)
    finally:
        resumed.pipeline.close()
