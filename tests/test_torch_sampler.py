"""The port's sampler and pipeline draw the same batches as gnn_tpu's:
``ladies_sample`` and ``BatchPipeline.train_epoch(epoch=e)`` yield
bit-identical arrays (both packages on their native cores, which draw
the same numbers; the numpy fallbacks draw other ones)."""
import dataclasses

import numpy as np
import pytest

from gnn_tpu.ops.hotdense import HotSpec as JHotSpec
from gnn_tpu.placement.engine import compute_sample_prob
from gnn_tpu.sampling import ladies as jlad
from gnn_tpu.sampling import pipeline as jpl
from gnn_tpu.utils.normalize import build_laplacian
from gnn_tpu_torch.ops.hotdense import HotSpec as THotSpec
from gnn_tpu_torch.sampling import ladies as tlad
from gnn_tpu_torch.sampling import pipeline as tpl

MB_FIELDS = ["input_nodes", "input_mask", "labels", "label_mask",
             "batch_nodes"]


def _assert_same_value(a, b, what):
    """Arrays equal with equal dtypes — except that the JAX package's
    bfloat16 values are the port's bfloat16-rounded float32 ones;
    scalars (0-d arrays, numpy or Python numbers) equal in value."""
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    if a.ndim == 0 or b.ndim == 0:
        assert a.item() == b.item(), (what, a, b)
        return
    if str(b.dtype) == "bfloat16":
        b = b.astype(np.float32)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def assert_same_batch(t, j):
    """Every array of a port MiniBatch equals the JAX package's."""
    assert t.n_input == j.n_input
    for f in MB_FIELDS:
        _assert_same_value(getattr(t, f), getattr(j, f), f)
    assert len(t.sampled_nodes) == len(j.sampled_nodes)
    for l, (a, b) in enumerate(zip(t.sampled_nodes, j.sampled_nodes)):
        _assert_same_value(a, b, f"sampled_nodes[{l}]")
    for l, (ta, ja) in enumerate(zip(t.adjs, j.adjs)):
        assert (ta is None) == (ja is None)
        if ta is None:
            continue
        for f in dataclasses.fields(ta):
            _assert_same_value(getattr(ta, f.name), getattr(ja, f.name),
                               f"adjs[{l}].{f.name}")


def _cfgs(graph, adj_format, stream, orders=(1, 1), sampler="ladies",
          ship_cold=True):
    lap = build_laplacian(graph.adj_full, "graphsage")
    prob = compute_sample_prob(lap, graph.train_nodes, sum(orders))
    kw = dict(batch_size=64, samp_num=128, orders=orders,
              num_nodes=lap.shape[0], num_classes=graph.num_classes,
              adj_format=adj_format, resident_val_free=True,
              resident_stream_tiles=stream, sampler=sampler,
              resident_ship_cold=ship_cold)
    jspec = tspec = None
    if adj_format in ("hot", "resident"):
        jspec = JHotSpec.from_sample_prob(prob, 256)
        tspec = THotSpec.from_sample_prob(prob, 256)
    return (lap, jlad.SamplerConfig(hot_spec=jspec, **kw),
            tlad.SamplerConfig(hot_spec=tspec, **kw))


@pytest.mark.parametrize("adj_format,stream,orders,ship_cold", [
    ("resident", True, (1, 1), True), ("resident", False, (1, 1), True),
    ("resident", True, (1, 0, 1), True), ("coo", False, (1, 1), True),
    ("hot", False, (1, 1), True), ("resident", False, (1, 1), False)])
def test_ladies_sample_matches_jax(small_graph, adj_format, stream,
                                   orders, ship_cold):
    lap, jcfg, tcfg = _cfgs(small_graph, adj_format, stream, orders,
                            ship_cold=ship_cold)
    for seed, lo in [(5, 0), (11, 200)]:
        tgt = small_graph.train_nodes[lo:lo + 64]
        jmb = jlad.ladies_sample(jcfg, seed, tgt, lap, small_graph.labels)
        tmb = tlad.ladies_sample(tcfg, seed, tgt, lap, small_graph.labels)
        assert_same_batch(tmb, jmb)


def test_pipeline_epochs_match_jax(small_graph):
    """train_epoch(epoch=e) yields the JAX pipeline's per-step batches
    (before its ShapeBook re-padding, which the port does not need), and
    leaves the val-sampling stream at the same state."""
    lap, jcfg, tcfg = _cfgs(small_graph, "resident", True)
    targets = small_graph.train_nodes[:640]
    jp = jpl.BatchPipeline(jcfg, lap, small_graph.labels, world_size=1,
                           pool_num=2, seed=3)
    tp = tpl.BatchPipeline(tcfg, lap, small_graph.labels, pool_num=2,
                           seed=3)
    try:
        for epoch in (0, 2):
            jb = [g[0] for g in jp._step_groups(targets, None, epoch)]
            tb = list(tp.train_epoch(targets, epoch=epoch))
            assert len(tb) == len(jb) == 10
            for t, j in zip(tb, jb):
                assert_same_batch(t, j)
            assert (tp._rng.bit_generator.state
                    == jp._rng.bit_generator.state)
            (jv,) = list(jp.eval_batches(small_graph.valid_nodes, 128,
                                         "val"))
            (tv,) = list(tp.eval_batches(small_graph.valid_nodes, 128,
                                         "val"))
            np.testing.assert_array_equal(tv.input_nodes,
                                          jv.input_nodes[0])
            np.testing.assert_array_equal(tv.labels, jv.labels[0])
    finally:
        tp.close()
        jp.pool.shutdown(wait=True, cancel_futures=True)


@pytest.mark.parametrize("adj_format,stream,ship_cold", [
    ("coo", False, True), ("hot", False, True), ("resident", False, True),
    ("resident", True, True), ("resident", False, False)])
def test_subgraph_sample_matches_jax(small_graph, adj_format, stream,
                                     ship_cold):
    """subgraph_sample gives the JAX package's batches (coo, hot, resident
    lite, resident stream tiles, resident full expansion); every deeper
    layer is one shared object in both packages."""
    lap, jcfg, tcfg = _cfgs(small_graph, adj_format, stream, (1, 1, 1),
                            sampler="subgraph", ship_cold=ship_cold)
    assert tlad.SAMPLERS["subgraph"] is tlad.subgraph_sample
    for seed, lo in [(5, 0), (11, 200)]:
        tgt = small_graph.train_nodes[lo:lo + 64]
        jmb = jlad.subgraph_sample(jcfg, seed, tgt, lap, small_graph.labels)
        tmb = tlad.subgraph_sample(tcfg, seed, tgt, lap, small_graph.labels)
        assert_same_batch(tmb, jmb)
        assert jmb.adjs[0] is jmb.adjs[1] and tmb.adjs[0] is tmb.adjs[1]
        assert tmb.adjs[1] is not tmb.adjs[2]
        cap = tcfg.layer_caps()[0]
        np.testing.assert_array_equal(
            tmb.sampled_nodes[0][: tmb.n_input], np.arange(tmb.n_input))
        assert all(a.nrows == a.ncols == cap for a in tmb.adjs[:2])


def test_to_device_batch_keeps_the_shared_layer(small_graph):
    """The subgraph sampler's square layer crosses to the device once:
    the moved batch shares one adjacency object where the host batch
    does, with the same arrays."""
    import torch

    from gnn_tpu_torch.train.stepfns import to_device_batch
    lap, _, tcfg = _cfgs(small_graph, "hot", False, (1, 1, 1),
                         sampler="subgraph")
    tmb = tlad.subgraph_sample(tcfg, 5, small_graph.train_nodes[:64], lap,
                               small_graph.labels)
    b = to_device_batch(tmb, "cpu")
    assert b.adjs[0] is b.adjs[1] and b.adjs[1] is not b.adjs[2]
    for f in ("rows", "cols_t", "vals", "colpos"):
        assert isinstance(getattr(b.adjs[0], f), torch.Tensor)
        np.testing.assert_array_equal(getattr(b.adjs[0], f).numpy(),
                                      getattr(tmb.adjs[0], f))
