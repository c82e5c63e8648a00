"""The port's GAT (gnn_tpu_torch.models.gat) against gnn_tpu's flax GAT, on
the same sampled batch (both packages sample on their native cores, so
the draws are the same), the same rebuilt resident layers, and weights
copied from flax by ``params_from_flax``.

* ``GATConv`` on a materialized ``HotDenseAdj`` (hot-block attention;
  the cold residual through the edge-stream attention kernels' plain
  versions with stream tiles on, the per-edge route with them off),
  heads 1 and 4: outputs to rtol = atol = 1e-4 and parameter gradients to
  rtol = 1e-3, atol = 1e-4 (float32 softmax terms summed in another
  order, then through a squared loss).
* Twins of the JAX package's regression tests: finite gradients at 50x
  magnitudes, a fully hot layer, one hot score matmul per forward.
* The per-edge route on a COO layer against the JAX per-edge route.
* The tile route (K5 and K2's plain versions) on a COO and a pattern
  layer against the JAX tile route, heads 1 and 4, same tolerances;
  ``"auto"`` picks the JAX route on both sides of the mask limit; the
  pattern and blocked transports give the COO result (1e-5); finite
  gradients at 50x magnitudes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.models import gat as jgat
from gnn_tpu.ops import hotdense as jhd
from gnn_tpu.ops import residentgraph as jrg
from gnn_tpu.placement.engine import compute_sample_prob
from gnn_tpu.sampling import ladies as jlad
from gnn_tpu.utils.normalize import build_laplacian
from gnn_tpu_torch.models import gat as tgat
from gnn_tpu_torch.ops import hotdense as thd
from gnn_tpu_torch.ops import residentgraph as trg
from gnn_tpu_torch.ops.sparse import to_device
from gnn_tpu_torch.sampling import ladies as tlad
from gnn_tpu_torch.weights import params_from_flax
from torch_sampler_width import same_sampler_width

OUT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _layers(graph, stream, hot_k=256, model="graphsage", seed=11):
    """Layer 0 of one sampled batch, rebuilt by both packages:
    ``(jax HotDenseAdj, port HotDenseAdj, sampled nodes, jax batch)``."""
    lap = build_laplacian(graph.adj_full, model)
    prob = compute_sample_prob(lap, graph.train_nodes, 2)
    kw = dict(batch_size=64, samp_num=128, orders=(1, 1),
              num_nodes=lap.shape[0], num_classes=graph.num_classes,
              adj_format="resident", compress=False,
              resident_ship_cold=True, resident_val_free=True,
              resident_stream_tiles=stream)
    jspec = jhd.HotSpec.from_sample_prob(prob, hot_k)
    d, dt = jhd.build_hot_dense(lap, jspec, np.float32)
    jhost = jrg.build_resident_graph(lap, jspec, d, dt)
    jhost.pop("val_free")
    n, k, ct = jhost.pop("n"), jhost.pop("k"), jhost.pop("col_trivial")
    jg = jrg.ResidentGraph(**{f: jnp.asarray(v) for f, v in jhost.items()},
                           n=n, k=k, col_trivial=ct)
    tspec = thd.HotSpec.from_sample_prob(prob, hot_k)
    td, tdt = thd.build_hot_dense(lap, tspec, torch.float32, "cpu")
    tg = trg.ResidentGraph.from_host(
        trg.build_resident_graph(lap, tspec, td, tdt), "cpu")
    tgt = graph.train_nodes[:64]
    same_sampler_width()
    jmb = jlad.ladies_sample(jlad.SamplerConfig(hot_spec=jspec, **kw), seed,
                             tgt, lap, graph.labels)
    tmb = tlad.ladies_sample(tlad.SamplerConfig(hot_spec=tspec, **kw), seed,
                             tgt, lap, graph.labels)
    ja = jrg.materialize_adjs(
        jg, list(jmb.adjs), [jnp.asarray(s) for s in jmb.sampled_nodes],
        jnp.asarray(jmb.input_nodes))[0]
    ta = trg.materialize_adjs(
        tg, [to_device(a, "cpu") for a in tmb.adjs],
        [torch.from_numpy(s) for s in tmb.sampled_nodes],
        torch.from_numpy(tmb.input_nodes))[0]
    np.testing.assert_array_equal(tmb.sampled_nodes[0], jmb.sampled_nodes[0])
    assert (ta.es_rc is not None) == stream
    return ja, ta, tmb.sampled_nodes[0], jmb


def _flax_grads_and_out(conv, variables, x, adj, sampled, n_rows):
    def loss(v_):
        return jnp.sum(conv.apply(v_, x, adj, sampled)[:n_rows] ** 2)
    out = np.asarray(conv.apply(variables, x, adj, sampled))
    grads = jax.grad(loss)(variables)
    return out, params_from_flax(jax.tree_util.tree_map(np.asarray, grads))


def _port_grads_and_out(conv, x, adj, sampled, n_rows):
    out = conv(torch.from_numpy(x), adj, torch.from_numpy(sampled))
    (out[:n_rows] ** 2).sum().backward()
    return (out.detach().numpy(),
            {n: p.grad.numpy() for n, p in conv.named_parameters()})


def _port_conv(variables, n_in, n_out, heads, impl="auto"):
    conv = tgat.GATConv(n_in, n_out, n_heads=heads, impl=impl)
    conv.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    return conv


@pytest.mark.parametrize("heads,stream", [(1, False), (4, False),
                                          (1, True), (4, True)])
def test_gatconv_on_resident_layer_matches_jax(small_graph, heads, stream):
    ja, ta, sampled, _ = _layers(small_graph, stream)
    rng = np.random.RandomState(2)
    x = rng.randn(ja.ncols, 24).astype(np.float32)
    n_rows = int(ja.n_valid_rows)
    jconv = jgat.GATConv(n_out=32, n_heads=heads)
    variables = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x), ja,
                           jnp.asarray(sampled))
    want, jgrads = _flax_grads_and_out(jconv, variables, jnp.asarray(x), ja,
                                       jnp.asarray(sampled), n_rows)
    got, tgrads = _port_grads_and_out(_port_conv(variables, 24, 32, heads),
                                      x, ta, sampled, n_rows)
    np.testing.assert_allclose(got[:n_rows], want[:n_rows], **OUT_TOL)
    assert set(tgrads) == set(jgrads)
    for name, g in tgrads.items():
        np.testing.assert_allclose(g, jgrads[name].numpy(), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("stream", [False, True])
def test_grads_finite_at_large_magnitudes(small_graph, stream):
    """Port twin of the JAX package's regression test: 50x features push
    q·k far past exp's float32 range; the premasked hot scores and the
    edge-stream attention's select-not-multiply backward keep every
    gradient finite."""
    _, ta, sampled, _ = _layers(small_graph, stream, model="gcn")
    rng = np.random.RandomState(2)
    x = torch.from_numpy(
        50.0 * rng.randn(ta.ncols, 24).astype(np.float32))
    conv = tgat.GATConv(24, 32, n_heads=2,
                        generator=torch.Generator().manual_seed(0))
    loss = (conv(x, ta, torch.from_numpy(sampled)) ** 2).sum()
    loss.backward()
    assert torch.isfinite(loss)
    for name, p in conv.named_parameters():
        assert torch.isfinite(p.grad).all(), name


def test_fully_hot_layer_matches_jax(small_graph):
    """hot_k >= num_nodes: no cold edge; the cold terms are skipped and
    the result still matches the JAX package."""
    n = small_graph.adj_full.shape[0]
    ja, ta, sampled, jmb = _layers(small_graph, False, hot_k=n)
    assert int(np.asarray(jmb.adjs[0].n_cold)) == 0
    rng = np.random.RandomState(4)
    x = rng.randn(ja.ncols, 24).astype(np.float32)
    n_rows = int(ja.n_valid_rows)
    jconv = jgat.GATConv(n_out=32, n_heads=2)
    variables = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x), ja,
                           jnp.asarray(sampled))
    want, _ = _flax_grads_and_out(jconv, variables, jnp.asarray(x), ja,
                                  jnp.asarray(sampled), n_rows)
    got, tgrads = _port_grads_and_out(_port_conv(variables, 24, 32, 2), x,
                                      ta, sampled, n_rows)
    np.testing.assert_allclose(got[:n_rows], want[:n_rows], **OUT_TOL)
    for name, g in tgrads.items():
        assert np.isfinite(g).all(), name
    # a zero-length cold residual takes the empty branch
    empty = dataclasses.replace(ta, rows=ta.rows[:0], cols=ta.cols[:0],
                                vals=ta.vals[:0])
    conv = _port_conv(variables, 24, 32, 2)
    with torch.no_grad():
        y = conv(torch.from_numpy(x), empty, torch.from_numpy(sampled))
    np.testing.assert_allclose(y.numpy()[:n_rows], want[:n_rows], **OUT_TOL)


def test_hot_score_matmul_runs_once(small_graph):
    """The [H, rh, ch] hot score product runs once per forward: the row
    max reads the same (detached) scores as the softmax terms."""
    _, ta, _, _ = _layers(small_graph, True)
    H, n_out = 2, 32
    rh = ta.present_row_slots.shape[0]
    ch = ta.present_col_slots.shape[0]
    shapes = []

    class Count(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in (torch.matmul, torch.Tensor.matmul, torch.bmm,
                        torch.einsum) and isinstance(out, torch.Tensor):
                shapes.append(tuple(out.shape))
            return out

    q = torch.randn(ta.nrows, n_out)
    k = torch.randn(ta.ncols, n_out)
    with Count():
        tgat.hot_attention(ta, tgat.DotScores(q, k, H), k.clone())
    assert shapes.count((H, rh, ch)) == 1, shapes


@pytest.mark.parametrize("heads", [1, 4])
def test_edge_route_matches_jax(small_graph, heads):
    """``impl="edge"`` on the value-carrying COO of one sampled layer,
    forward and parameter gradients."""
    from gnn_tpu.ops import sparse as jsp
    from gnn_tpu_torch.ops import sparse as tsp

    lap = build_laplacian(small_graph.adj_full, "graphsage")
    cfg = jlad.SamplerConfig(batch_size=64, samp_num=128, orders=(1, 1),
                             num_nodes=lap.shape[0],
                             num_classes=small_graph.num_classes,
                             compress=False)
    mb = jlad.ladies_sample(cfg, 11, small_graph.train_nodes[:64], lap,
                            small_graph.labels)
    a = mb.adjs[0]
    args = (np.asarray(a.rows), np.asarray(a.cols), np.asarray(a.vals),
            int(a.n_valid_rows), int(a.n_valid_cols), a.nrows, a.ncols)
    n = int(np.count_nonzero(args[2]))
    ja = jax.tree_util.tree_map(jnp.asarray, jsp.pack_coo(
        args[0][:n], args[1][:n], args[2][:n], *args[3:]))
    ta = tsp.to_device(tsp.pack_coo(args[0][:n], args[1][:n], args[2][:n],
                                    *args[3:]), "cpu")
    sampled = np.asarray(mb.sampled_nodes[0])
    rng = np.random.RandomState(5)
    x = rng.randn(a.ncols, 16).astype(np.float32)
    jconv = jgat.GATConv(n_out=32, n_heads=heads, impl="edge")
    variables = jconv.init(jax.random.PRNGKey(1), jnp.asarray(x), ja,
                           jnp.asarray(sampled))
    n_rows = int(a.n_valid_rows)
    want, jgrads = _flax_grads_and_out(jconv, variables, jnp.asarray(x), ja,
                                       jnp.asarray(sampled), n_rows)
    got, tgrads = _port_grads_and_out(
        _port_conv(variables, 16, 32, heads, impl="edge"), x, ta, sampled,
        n_rows)
    np.testing.assert_allclose(got[:n_rows], want[:n_rows], **OUT_TOL)
    for name, g in tgrads.items():
        np.testing.assert_allclose(g, jgrads[name].numpy(), **GRAD_TOL,
                                   err_msg=name)


def _sampled_layer(graph, seed=11):
    """Layer 0 of one sampled COO batch (JAX sampler, native core) as
    host arrays: ``(rows, cols, vals, n_valid_rows, n_valid_cols, nrows,
    ncols)`` of its live edges, and the layer's sampled nodes."""
    lap = build_laplacian(graph.adj_full, "graphsage")
    cfg = jlad.SamplerConfig(batch_size=64, samp_num=128, orders=(1, 1),
                             num_nodes=lap.shape[0],
                             num_classes=graph.num_classes, compress=False)
    mb = jlad.ladies_sample(cfg, seed, graph.train_nodes[:64], lap,
                            graph.labels)
    a = mb.adjs[0]
    vals = np.asarray(a.vals)
    n = int(np.count_nonzero(vals))
    args = (np.asarray(a.rows)[:n], np.asarray(a.cols)[:n], vals[:n],
            int(a.n_valid_rows), int(a.n_valid_cols), a.nrows, a.ncols)
    return args, np.asarray(mb.sampled_nodes[0])


def _packed(args, transport):
    """The same edges packed by both packages: ``(jax adj, port adj)``
    (``blocked`` exists on the port side only: the JAX GAT does not take
    it)."""
    from gnn_tpu.ops import sparse as jsp
    from gnn_tpu_torch.ops import sparse as tsp
    if transport == "coo":
        return (jax.tree_util.tree_map(jnp.asarray, jsp.pack_coo(*args)),
                tsp.to_device(tsp.pack_coo(*args), "cpu"))
    if transport == "pattern":
        pargs = (args[0], args[1]) + args[3:]
        return (jax.tree_util.tree_map(jnp.asarray,
                                       jsp.pack_pattern(*pargs)),
                tsp.to_device(tsp.pack_pattern(*pargs), "cpu"))
    return None, tsp.to_device(tsp.pack_blocked(*args), "cpu")


@pytest.mark.parametrize("transport", ["coo", "pattern"])
@pytest.mark.parametrize("heads", [1, 4])
def test_tile_route_matches_jax(small_graph, heads, transport):
    """``impl="tile"`` (scores through K5's plain version, the masked
    tile softmax, aggregation through K2's; the backward through both in
    both orientations) against the JAX tile route: output and every
    parameter gradient."""
    args, sampled = _sampled_layer(small_graph)
    ja, ta = _packed(args, transport)
    rng = np.random.RandomState(6)
    x = rng.randn(args[6], 16).astype(np.float32)
    jconv = jgat.GATConv(n_out=32, n_heads=heads, impl="tile")
    variables = jconv.init(jax.random.PRNGKey(2), jnp.asarray(x), ja,
                           jnp.asarray(sampled))
    n_rows = args[3]
    want, jgrads = _flax_grads_and_out(jconv, variables, jnp.asarray(x), ja,
                                       jnp.asarray(sampled), n_rows)
    got, tgrads = _port_grads_and_out(
        _port_conv(variables, 16, 32, heads, impl="tile"), x, ta, sampled,
        n_rows)
    np.testing.assert_allclose(got[:n_rows], want[:n_rows], **OUT_TOL)
    assert set(tgrads) == set(jgrads)
    for name, g in tgrads.items():
        np.testing.assert_allclose(g, jgrads[name].numpy(), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("limit_delta,route", [(0, "tile"), (-1, "edge")])
def test_auto_picks_the_jax_route(small_graph, monkeypatch, limit_delta,
                                  route):
    """``"auto"`` takes the tile route while the layer's dense tile mask
    holds at most ``_TILE_MASK_LIMIT`` floats, on both sides of the limit,
    as the JAX GATConv does."""
    args, sampled = _sampled_layer(small_graph)
    ja, ta = _packed(args, "coo")
    floats = args[5] * args[6]          # every tile of the padded layer
    x = np.random.RandomState(7).randn(args[6], 16).astype(np.float32)
    jconv = jgat.GATConv(n_out=16)
    variables = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x), ja,
                           jnp.asarray(sampled))
    for mod in (jgat, tgat):
        monkeypatch.setattr(mod, "_TILE_MASK_LIMIT", floats + limit_delta)
    seen = []
    for mod, names in ((jgat, ("_coo_to_tilewise",
                               "edge_attention_aggregate")),
                       (tgat, ("tile_attention_aggregate",
                               "edge_attention_aggregate"))):
        for name in names:
            def rec(*a, _f=getattr(mod, name), _n=name, _m=mod, **k):
                seen.append((_m.__name__, "edge" if "edge" in _n else "tile"))
                return _f(*a, **k)
            monkeypatch.setattr(mod, name, rec)
    jconv.apply(variables, jnp.asarray(x), ja, jnp.asarray(sampled))
    tgat.GATConv(16, 16)(torch.from_numpy(x), ta, torch.from_numpy(sampled))
    assert seen == [(jgat.__name__, route), (tgat.__name__, route)]


@pytest.mark.parametrize("impl", ["tile", "edge"])
def test_pattern_and_blocked_transports_give_the_coo_result(small_graph,
                                                            impl):
    """The same edges shipped as a value-carrying COO, as the pattern
    transport, or as blocked tiles give the same attention output."""
    args, sampled = _sampled_layer(small_graph)
    x = torch.from_numpy(
        np.random.RandomState(8).randn(args[6], 16).astype(np.float32))
    conv = tgat.GATConv(16, 32, n_heads=2, impl=impl,
                        generator=torch.Generator().manual_seed(0))
    s = torch.from_numpy(sampled)
    with torch.no_grad():
        want = conv(x, _packed(args, "coo")[1], s)
        for transport in ("pattern", "blocked"):
            got = conv(x, _packed(args, transport)[1], s)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_tile_route_grads_finite_at_large_magnitudes(small_graph):
    """50x features push q·k far past exp's float32 range: the tile
    softmax masks to -inf before the exp, and rows without an edge get
    zero attention, so every gradient stays finite."""
    args, sampled = _sampled_layer(small_graph)
    _, ta = _packed(args, "pattern")
    x = torch.from_numpy(50.0 * np.random.RandomState(9).randn(
        args[6], 16).astype(np.float32))
    conv = tgat.GATConv(16, 32, n_heads=2, impl="tile",
                        generator=torch.Generator().manual_seed(0))
    out = conv(x, ta, torch.from_numpy(sampled))
    loss = (out ** 2).sum()
    loss.backward()
    assert torch.isfinite(loss)
    for name, p in conv.named_parameters():
        assert torch.isfinite(p.grad).all(), name


@pytest.mark.parametrize("stream", [False, True])
def test_one_part_sharded_layer_matches_replicated(small_graph, stream):
    """The part-sharded attention route on a one-part shard (the block's
    columns all owned, every part sum a no-op) gives the replicated
    layer's output and gradients: its score pass without gradient, its
    recomputed terms and their Function agree with the one-matmul
    route."""
    from gnn_tpu_torch.parallel.dist import PartGroup
    _, ta, sampled, _ = _layers(small_graph, stream)
    sharded = dataclasses.replace(ta, part_axis=PartGroup())
    rng = np.random.default_rng(5)
    x = rng.normal(size=(ta.ncols, 16)).astype(np.float32)
    n_rows = ta.n_valid_rows
    outs = []
    for adj in (ta, sharded):
        conv = tgat.GATConv(16, 32, n_heads=2,
                            generator=torch.Generator().manual_seed(0))
        outs.append(_port_grads_and_out(conv, x, adj, sampled, n_rows))
    (o1, g1), (o2, g2) = outs
    np.testing.assert_allclose(o2[:n_rows], o1[:n_rows], rtol=1e-6,
                               atol=1e-6)
    assert g1.keys() == g2.keys()
    for name in g1:
        np.testing.assert_allclose(g2[name], g1[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
