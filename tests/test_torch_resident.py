"""The port's resident-graph rebuild (gnn_tpu_torch.ops.residentgraph,
.hotdense) against gnn_tpu's, on the ``small_graph`` fixture with a
float32 hot block: the same host payloads, the same materialized
HotDenseAdj fields, and the same hot_forward / hot_transpose. Both
packages sample on their native cores (same draws). Tolerance for the
aggregations: rtol = atol = 1e-5 (float32 sums in another order); the
rebuilt index arrays must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.ops import hotdense as jhd
from gnn_tpu.ops import residentgraph as jrg
from gnn_tpu.ops.sparse import spmm as jspmm, spmm_transpose as jspmm_t
from gnn_tpu.placement.engine import compute_sample_prob
from gnn_tpu.sampling import ladies as jlad
from gnn_tpu.utils.normalize import build_laplacian
from gnn_tpu_torch.ops import hotdense as thd
from gnn_tpu_torch.ops import residentgraph as trg
from gnn_tpu_torch.ops.sparse import (spmm as tspmm,
                                      spmm_transpose as tspmm_t,
                                      to_device)
from gnn_tpu_torch.sampling import ladies as tlad

TOL = dict(rtol=1e-5, atol=1e-5)

FIELDS = ["rows", "cols", "vals", "colpos", "nfh", "rowpos", "nf_col",
          "present_row_slots", "row_cmp_idx", "present_col_slots",
          "col_cmp_idx", "es_coords", "es_rc", "es_off", "es_ord",
          "es_vals", "es_rv", "es_nf"]
STATIC = ["nrows", "ncols", "k", "es_bm", "es_bk", "n_valid_rows",
          "n_valid_cols"]


def _both(graph, stream, norm, weighted, orders=(1, 1), ship_cold=True):
    lap = build_laplacian(graph.adj_full, "graphsage", norm=norm)
    if weighted:
        lap = lap.copy()
        lap.data = (lap.data * np.random.default_rng(3).uniform(
            0.5, 2.0, len(lap.data))).astype(np.float32)
    prob = compute_sample_prob(lap, graph.train_nodes, sum(orders))
    kw = dict(batch_size=64, samp_num=128, orders=orders,
              num_nodes=lap.shape[0], num_classes=graph.num_classes,
              adj_format="resident", compress=False,
              resident_ship_cold=ship_cold, resident_val_free=not weighted,
              resident_stream_tiles=stream)
    # JAX side
    jspec = jhd.HotSpec.from_sample_prob(prob, 256)
    d, dt = jhd.build_hot_dense(lap, jspec, np.float32)
    jhost = jrg.build_resident_graph(lap, jspec, d, dt)
    assert jhost.pop("val_free") is (not weighted)
    n, k, ct = jhost.pop("n"), jhost.pop("k"), jhost.pop("col_trivial")
    jg = jrg.ResidentGraph(**{f: jnp.asarray(v) for f, v in jhost.items()},
                           n=n, k=k, col_trivial=ct)
    jcfg = jlad.SamplerConfig(hot_spec=jspec, **kw)
    # port
    tspec = thd.HotSpec.from_sample_prob(prob, 256)
    td, tdt = thd.build_hot_dense(lap, tspec, torch.float32, "cpu")
    np.testing.assert_array_equal(td.numpy(), d)
    np.testing.assert_array_equal(tdt.numpy(), dt)
    thost = trg.build_resident_graph(lap, tspec, td, tdt)
    tg = trg.ResidentGraph.from_host(thost, "cpu")
    tcfg = tlad.SamplerConfig(hot_spec=tspec, **kw)
    return lap, jg, jcfg, tg, tcfg


@pytest.mark.parametrize("stream,norm,weighted", [
    (True, "row", False), (False, "row", False), (True, "sym", False),
    (True, "row", True), (False, "row", True)])
def test_materialized_layers_match_jax(small_graph, stream, norm,
                                       weighted):
    lap, jg, jcfg, tg, tcfg = _both(small_graph, stream, norm, weighted)
    tgt = small_graph.train_nodes[:64]
    jmb = jlad.ladies_sample(jcfg, 5, tgt, lap, small_graph.labels)
    tmb = tlad.ladies_sample(tcfg, 5, tgt, lap, small_graph.labels)
    jadjs = jrg.materialize_adjs(
        jg, list(jmb.adjs), [jnp.asarray(s) for s in jmb.sampled_nodes],
        jnp.asarray(jmb.input_nodes))
    tadjs = trg.materialize_adjs(
        tg, [to_device(a, "cpu") for a in tmb.adjs],
        [torch.from_numpy(s) for s in tmb.sampled_nodes],
        torch.from_numpy(tmb.input_nodes))
    rng = np.random.default_rng(0)
    for l, (ja, ta) in enumerate(zip(jadjs, tadjs)):
        assert (ja.es_rc is not None) == stream
        for f in STATIC:
            assert int(getattr(ta, f)) == int(getattr(ja, f)), (l, f)
        for f in FIELDS:
            jv, tv = getattr(ja, f), getattr(ta, f)
            assert (jv is None) == (tv is None), (l, f)
            if jv is not None:
                np.testing.assert_array_equal(
                    tv.numpy(), np.asarray(jv).astype(tv.numpy().dtype),
                    err_msg=f"layer {l} {f}")
        x = rng.normal(size=(ja.ncols, 8)).astype(np.float32)
        g = rng.normal(size=(ja.nrows, 8)).astype(np.float32)
        np.testing.assert_allclose(
            tspmm(ta, torch.from_numpy(x)).numpy(),
            np.asarray(jspmm(ja, jnp.asarray(x))), **TOL,
            err_msg=f"layer {l} hot_forward")
        np.testing.assert_allclose(
            tspmm_t(ta, torch.from_numpy(g)).numpy(),
            np.asarray(jspmm_t(ja, jnp.asarray(g))), **TOL,
            err_msg=f"layer {l} hot_transpose")


def test_bf16_hot_block_matches_jax(small_graph):
    """A bfloat16 hot block: bf16 x bf16 products summed in float32 in
    both packages (rtol = atol = 1e-4: the same products, summed in
    another order, over bf16-rounded inputs)."""
    lap = build_laplacian(small_graph.adj_full, "graphsage")
    prob = compute_sample_prob(lap, small_graph.train_nodes, 2)
    jspec = jhd.HotSpec.from_sample_prob(prob, 256)
    tspec = thd.HotSpec.from_sample_prob(prob, 256)
    d, dt = jhd.build_hot_dense(lap, jspec, jnp.bfloat16)
    td, tdt = thd.build_hot_dense(lap, tspec, torch.bfloat16, "cpu")
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(d).astype(np.float32))
    kw = dict(batch_size=64, samp_num=128, orders=(1, 1),
              num_nodes=lap.shape[0], num_classes=small_graph.num_classes,
              adj_format="resident", resident_val_free=True,
              resident_stream_tiles=True)
    jhost = jrg.build_resident_graph(lap, jspec, d, dt)
    jhost.pop("val_free")
    n, k, ct = jhost.pop("n"), jhost.pop("k"), jhost.pop("col_trivial")
    jg = jrg.ResidentGraph(**{f: jnp.asarray(v) for f, v in jhost.items()},
                           n=n, k=k, col_trivial=ct)
    tg = trg.ResidentGraph.from_host(
        trg.build_resident_graph(lap, tspec, td, tdt), "cpu")
    tgt = small_graph.train_nodes[64:128]
    jmb = jlad.ladies_sample(jlad.SamplerConfig(hot_spec=jspec, **kw), 9,
                             tgt, lap, small_graph.labels)
    tmb = tlad.ladies_sample(tlad.SamplerConfig(hot_spec=tspec, **kw), 9,
                             tgt, lap, small_graph.labels)
    jadjs = jrg.materialize_adjs(
        jg, list(jmb.adjs), [jnp.asarray(s) for s in jmb.sampled_nodes],
        jnp.asarray(jmb.input_nodes))
    tadjs = trg.materialize_adjs(
        tg, [to_device(a, "cpu") for a in tmb.adjs],
        [torch.from_numpy(s) for s in tmb.sampled_nodes],
        torch.from_numpy(tmb.input_nodes))
    rng = np.random.default_rng(1)
    for ja, ta in zip(jadjs, tadjs):
        x = rng.normal(size=(ja.ncols, 8)).astype(np.float32)
        np.testing.assert_allclose(
            tspmm(ta, torch.from_numpy(x)).numpy(),
            np.asarray(jspmm(ja, jnp.asarray(x))), rtol=1e-4, atol=1e-4)


def _materialize_both(jg, jcfg, tg, tcfg, lap, graph, seed, tgt):
    jmb = jlad.ladies_sample(jcfg, seed, tgt, lap, graph.labels)
    tmb = tlad.ladies_sample(tcfg, seed, tgt, lap, graph.labels)
    jadjs = jrg.materialize_adjs(
        jg, list(jmb.adjs), [jnp.asarray(s) for s in jmb.sampled_nodes],
        jnp.asarray(jmb.input_nodes))
    tadjs = trg.materialize_adjs(
        tg, [to_device(a, "cpu") for a in tmb.adjs],
        [torch.from_numpy(s) for s in tmb.sampled_nodes],
        torch.from_numpy(tmb.input_nodes))
    return jadjs, tadjs


@pytest.mark.parametrize("norm,weighted", [
    ("row", False), ("sym", False), ("row", True)])
def test_full_expansion_matches_jax(small_graph, norm, weighted):
    """``resident_ship_cold=False``: the device rebuilds the cold COO from
    the resident CSR (span expansion, column filter, hot/cold split,
    compaction). Every rebuilt array equals the JAX package's, and the
    layer's spmm and its transpose match JAX's and the lite mode's on the
    same batch (the same draws)."""
    lap, jg, jcfg, tg, tcfg = _both(small_graph, False, norm, weighted,
                                    ship_cold=False)
    _, _, _, lg, lcfg = _both(small_graph, False, norm, weighted)
    tgt = small_graph.train_nodes[:64]
    jadjs, tadjs = _materialize_both(jg, jcfg, tg, tcfg, lap, small_graph,
                                     5, tgt)
    _, ladjs = _materialize_both(jg, jcfg, lg, lcfg, lap, small_graph, 5,
                                 tgt)
    rng = np.random.default_rng(2)
    for l, (ja, ta, la) in enumerate(zip(jadjs, tadjs, ladjs)):
        assert not ta.t_sorted and ta.es_rc is None
        for f in STATIC:
            assert int(getattr(ta, f)) == int(getattr(ja, f)), (l, f)
        for f in FIELDS + ["rows_t", "cols_t", "vals_t"]:
            jv, tv = getattr(ja, f), getattr(ta, f)
            assert (jv is None) == (tv is None), (l, f)
            if jv is not None:
                np.testing.assert_array_equal(
                    tv.numpy(), np.asarray(jv).astype(tv.numpy().dtype),
                    err_msg=f"layer {l} {f}")
        assert int(np.count_nonzero(ta.vals.numpy())) > 0
        x = torch.from_numpy(rng.normal(size=(ta.ncols, 8)).astype(
            np.float32))
        g = torch.from_numpy(rng.normal(size=(ta.nrows, 8)).astype(
            np.float32))
        y = tspmm(ta, x)
        np.testing.assert_allclose(
            y.numpy(), np.asarray(jspmm(ja, jnp.asarray(x.numpy()))), **TOL)
        np.testing.assert_allclose(y.numpy(), tspmm(la, x).numpy(), **TOL)
        np.testing.assert_allclose(tspmm_t(ta, g).numpy(),
                                   tspmm_t(la, g).numpy(), **TOL)


def test_full_expansion_on_a_sharded_graph_raises(small_graph):
    """The part-sharded branch stays with the multi-device queue."""
    lap, _, _, tg, tcfg = _both(small_graph, False, "row", False,
                                ship_cold=False)
    tmb = tlad.ladies_sample(tcfg, 5, small_graph.train_nodes[:64], lap,
                             small_graph.labels)
    ref = to_device(tmb.adjs[1], "cpu")
    tg.part_axis = "part"
    ids = torch.from_numpy(tmb.input_nodes).long()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        trg.materialize_layer(tg, ref, ids[: ref.nrows], ids[: ref.ncols])
