"""The part-sharded resident graph and feature sources of the port
(gnn_tpu_torch.parallel.shardedresident, .feature_cache, the sharded
branches of ops.hotdense / ops.residentgraph) against the JAX package's
``part`` mesh, in one process.

The part ranks here are threads of the test process: each runs the
port's code on its own shard, and their collectives meet in
:class:`ThreadPart`, which sums (in part order) or takes the max of the
parts' tensors. The JAX package runs its ``shard_map`` over four of the
eight virtual CPU devices. Lookups, the full-expansion COO, the CSR
shards and the feature gathers must be exact; one layer's products
agree within 1e-6 (float32 sums in another order). The spawned gloo
ranks of the training path are in `tests/test_torch_parts_train.py`."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec as P

from gnn_tpu.ops import hotdense as jhd
from gnn_tpu.ops import residentgraph as jrg
from gnn_tpu.ops.sparse import spmm as jspmm, spmm_transpose as jspmm_t
from gnn_tpu.parallel import feature_cache as jfc
from gnn_tpu.parallel import shardedresident as jsr
from gnn_tpu.placement import engine as jeng
from gnn_tpu.sampling import ladies as jlad
from gnn_tpu.utils.normalize import build_laplacian
from gnn_tpu_torch.ops import hotdense as thd
from gnn_tpu_torch.ops import residentgraph as trg
from gnn_tpu_torch.ops.sparse import (spmm as tspmm,
                                      spmm_transpose as tspmm_t, to_device)
from gnn_tpu_torch.parallel import feature_cache as tfc
from gnn_tpu_torch.parallel import shardedresident as tsr
from gnn_tpu_torch.parallel.dist import PartGroup
from gnn_tpu_torch.placement import engine as teng
from gnn_tpu_torch.sampling import ladies as tlad
from torch_sampler_width import same_sampler_width

N_PARTS = 4
TOL = dict(rtol=1e-6, atol=1e-6)


class _Meeting:
    """Where the part threads' collectives meet."""

    def __init__(self, size):
        self.barrier = threading.Barrier(size, timeout=60)
        self.slots = [None] * size

    def reduce(self, rank, t, op):
        self.slots[rank] = t.clone()
        self.barrier.wait()
        if op == dist.ReduceOp.SUM:
            acc = self.slots[0].clone()
            for s in self.slots[1:]:
                acc += s
        else:
            acc = torch.stack(self.slots).amax(dim=0)
        self.barrier.wait()     # every part read the slots
        t.copy_(acc)


@dataclasses.dataclass(frozen=True)
class ThreadPart(PartGroup):
    meeting: object = None

    def all_reduce_(self, t, op):
        self.meeting.reduce(self.rank, t, op)


def run_parts(n_parts, fn):
    """``fn(part)`` on ``n_parts`` threads, one a part; their results."""
    meeting = _Meeting(n_parts)
    out, errs = [None] * n_parts, []

    def body(p):
        try:
            out[p] = fn(ThreadPart(p, n_parts, None, meeting))
        except BaseException as e:  # noqa: B902 (re-raised below)
            errs.append(e)
            meeting.barrier.abort()
    threads = [threading.Thread(target=body, args=(p,))
               for p in range(n_parts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    if errs:
        raise errs[0]
    return out


def _setup(graph, orders=(1, 1), val_free=True, ship_cold=True,
           stream=False, hot_k=256):
    """Both packages' state and sampler configs (float32 blocks)."""
    lap = build_laplacian(graph.adj_full, "graphsage")
    prob = jeng.compute_sample_prob(lap, graph.train_nodes, sum(orders))
    kw = dict(batch_size=64, samp_num=128, orders=orders,
              num_nodes=lap.shape[0], num_classes=graph.num_classes,
              adj_format="resident", compress=False,
              resident_ship_cold=ship_cold,
              resident_val_free=val_free and ship_cold,
              resident_stream_tiles=stream)
    jspec = jhd.HotSpec.from_sample_prob(prob, hot_k)
    d, dt = jhd.build_hot_dense(lap, jspec, np.float32)
    tspec = thd.HotSpec.from_sample_prob(prob, hot_k)
    td, tdt = thd.build_hot_dense(lap, tspec, torch.float32, "cpu")
    return dict(lap=lap, jspec=jspec, d=d, dt=dt,
                jcfg=jlad.SamplerConfig(hot_spec=jspec, **kw),
                tcfg=tlad.SamplerConfig(hot_spec=tspec, **kw),
                rg=trg.build_resident_graph(lap, tspec, td, tdt))


def _jax_sharded(s, ship_csr):
    g_sh, _ = jsr.build_sharded_resident(s["lap"], s["jspec"], s["d"],
                                         s["dt"], N_PARTS,
                                         ship_csr=ship_csr)
    return g_sh


def _part_mesh():
    return Mesh(np.asarray(jax.devices()[:N_PARTS]), ("part",))


def test_shards_and_lookups_match(small_graph):
    """Each part's shard holds the JAX package's stacked arrays for that
    part; the parts' partials sum to the replicated table's lookups (the
    pad id ``n`` and the last shard's padded tail included: slot -1, row
    and column factor 0); the CSR spans find each row's edges on exactly
    one part."""
    s = _setup(small_graph, ship_cold=False)
    g_sh = _jax_sharded(s, ship_csr=True)
    rg = s["rg"]
    n = rg["n"]
    shards = [tsr.shard_resident_state(rg, PartGroup(p, N_PARTS), "cpu",
                                       ship_csr=True)
              for p in range(N_PARTS)]
    for p, sh in enumerate(shards):
        assert sh.nsh == g_sh.nsh
        for f in ("slot_shard", "row_val_shard", "col_val_shard", "dense",
                  "dense_t", "row_ptr_shard", "col_idx_shard", "val_shard"):
            np.testing.assert_array_equal(getattr(sh, f).numpy(),
                                          np.asarray(getattr(g_sh, f))[p],
                                          err_msg=f"{f} part {p}")
    ids = np.concatenate([np.random.default_rng(0).integers(0, n, 500),
                          [n, n - 1, 0, N_PARTS * shards[0].nsh - 1]])
    t = torch.from_numpy(ids)
    table = trg.ResidentGraph.from_host(rg, "cpu")
    real = ids < n
    slots = sum(sh.slot_partial(t) for sh in shards) - 1
    np.testing.assert_array_equal(slots.numpy(),
                                  table.slot_lookup(t).numpy())
    for part_fn, want in (("rowval_partial", rg["row_val"]),
                          ("colval_partial", rg["col_val"])):
        got = sum(getattr(sh, part_fn)(t) for sh in shards).numpy()
        np.testing.assert_array_equal(got[real], want[ids[real]])
        np.testing.assert_array_equal(got[~real], 0.0)
    spans = [sh.csr_spans(t) for sh in shards]
    owners = np.stack([deg.numpy() > 0 for _, deg in spans])
    deg_full = np.diff(rg["row_ptr"])
    np.testing.assert_array_equal(owners.sum(0), (ids < n)
                                  & (deg_full[np.minimum(ids, n - 1)] > 0))
    for i in np.flatnonzero(owners.any(0)):
        p = int(np.argmax(owners[:, i]))
        start, deg = (int(a[i]) for a in spans[p])
        cols = shards[p].col_idx_shard.numpy()[start:start + deg]
        lo, hi = rg["row_ptr"][ids[i]], rg["row_ptr"][ids[i] + 1]
        np.testing.assert_array_equal(cols, rg["col_idx"][lo:hi])


def test_csr_row_shards_match_jax(small_graph):
    lap = build_laplacian(small_graph.adj_full, "graphsage").tocsr()
    for n_parts in (2, 3, 4):
        nsh = -(-lap.shape[0] // n_parts)
        got = tsr._csr_row_shards(lap.indptr, lap.indices,
                                  lap.data.astype(np.float32), n_parts, nsh)
        want = jsr._csr_row_shards(lap.indptr, lap.indices,
                                   lap.data.astype(np.float32), n_parts, nsh)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _jax_products(s, jmb, xs, gs, ship_cold):
    """``spmm`` and ``spmm_transpose`` of every aggregating layer on each
    part of the JAX package's sharded state ([P, ...] per layer)."""
    g_sh = _jax_sharded(s, ship_csr=not ship_cold)
    adjs = list(jmb.adjs)
    samp = [jnp.asarray(a) for a in jmb.sampled_nodes]
    inp = jnp.asarray(jmb.input_nodes)

    def f(g_stacked, adjs, samp, inp, xs, gs):
        mat = jrg.materialize_adjs(jsr.local_shard(g_stacked), adjs, samp,
                                   inp)
        ys = [jspmm(a, x)[None] for a, x in zip(mat, xs) if a is not None]
        dxs = [jspmm_t(a, g)[None] for a, g in zip(mat, gs)
               if a is not None]
        return ys, dxs

    ys, dxs = jax.jit(jax.shard_map(
        f, mesh=_part_mesh(), in_specs=(P("part"), P(), P(), P(), P(), P()),
        out_specs=(P("part"), P("part")), check_vma=False))(
        g_sh, adjs, samp, inp,
        [None if x is None else jnp.asarray(x) for x in xs],
        [None if g is None else jnp.asarray(g) for g in gs])
    return [np.asarray(y) for y in ys], [np.asarray(d) for d in dxs]


def _port_layers(s, tmb, ship_cold, fn):
    """``fn(part, materialized layers)`` on each thread part."""
    adjs = [to_device(a, "cpu") for a in tmb.adjs]
    samp = [torch.from_numpy(a) for a in tmb.sampled_nodes]
    inp = torch.from_numpy(tmb.input_nodes)

    def body(part):
        g = tsr.shard_resident_state(s["rg"], part, "cpu",
                                     ship_csr=not ship_cold)
        return fn(part, trg.materialize_adjs(g, adjs, samp, inp))
    return run_parts(N_PARTS, body)


def _operands(tmb, width=8):
    """Per layer, ``x`` and ``g`` operands (None at order-0 layers)."""
    rng = np.random.default_rng(1)
    xs, gs = [], []
    for a in tmb.adjs:
        xs.append(None if a is None else rng.normal(
            size=(a.ncols, width)).astype(np.float32))
        gs.append(None if a is None else rng.normal(
            size=(a.nrows, width)).astype(np.float32))
    return xs, gs


@pytest.mark.parametrize("ship_cold,val_free,orders", [
    (True, True, (1, 1)), (True, False, (1, 1)), (True, True, (1, 0, 1)),
    (True, False, (1, 0, 1)), (False, True, (1, 1))])
def test_materialize_matches_jax_sharded(small_graph, ship_cold, val_free,
                                         orders):
    """Lite mode (values recomputed or shipped) and full expansion: every
    part's rebuilt layers give the JAX package's sharded products, both
    ways, within 1e-6, and every part the same bits."""
    s = _setup(small_graph, orders, val_free, ship_cold)
    tgt = small_graph.train_nodes[:64]
    same_sampler_width()
    jmb = jlad.ladies_sample(s["jcfg"], 5, tgt, s["lap"], small_graph.labels)
    tmb = tlad.ladies_sample(s["tcfg"], 5, tgt, s["lap"], small_graph.labels)
    np.testing.assert_array_equal(tmb.input_nodes, jmb.input_nodes)
    xs, gs = _operands(tmb)

    def products(part, mat):
        layers = [(a, x, g) for a, x, g in zip(mat, xs, gs) if a is not None]
        assert all(a.part_axis is part and a.cold_partial == (not ship_cold)
                   for a, _, _ in layers)
        return [(tspmm(a, torch.from_numpy(x)).numpy(),
                 tspmm_t(a, torch.from_numpy(g)).numpy())
                for a, x, g in layers]

    got = _port_layers(s, tmb, ship_cold, products)
    jys, jdxs = _jax_products(s, jmb, xs, gs, ship_cold)
    assert len(jys) == len(got[0]) == sum(x is not None for x in xs)
    for l in range(len(jys)):
        for p in range(N_PARTS):
            y, dx = got[p][l]
            np.testing.assert_array_equal(y, got[0][l][0])
            np.testing.assert_array_equal(dx, got[0][l][1])
            np.testing.assert_allclose(y, jys[l][p], err_msg=f"l{l} p{p}",
                                       **TOL)
            np.testing.assert_allclose(dx, jdxs[l][p], err_msg=f"l{l} p{p}",
                                       **TOL)


def test_full_expansion_partials_sum_to_the_replicated_coo(small_graph):
    """Each part's cold COO holds the cold edges of the rows it owns: the
    parts' COOs, as dense matrices, sum exactly to the replicated
    expansion's, and the slot plumbing is the replicated one on every
    part."""
    s = _setup(small_graph, ship_cold=False)
    tmb = tlad.ladies_sample(s["tcfg"], 5, small_graph.train_nodes[:64],
                             s["lap"], small_graph.labels)
    table = trg.ResidentGraph.from_host(s["rg"], "cpu")
    want = trg.materialize_adjs(
        table, [to_device(a, "cpu") for a in tmb.adjs],
        [torch.from_numpy(a) for a in tmb.sampled_nodes],
        torch.from_numpy(tmb.input_nodes))

    def coo_dense(a):
        d = torch.zeros(a.nrows, a.ncols)
        d.index_put_((a.rows.long(), a.cols.long()), a.vals, accumulate=True)
        return d

    got = _port_layers(s, tmb, False, lambda part, mat: [
        (coo_dense(a), a) for a in mat])
    for l, w in enumerate(want):
        total = sum(g[l][0] for g in got)
        torch.testing.assert_close(total, coo_dense(w), rtol=0, atol=0)
        # each edge on one part: the parts' supports are disjoint
        assert sum(int((g[l][0] != 0).sum()) for g in got) == int(
            (total != 0).sum())
        for g in got:
            for f in ("colpos", "nfh", "rowpos", "nf_col", "row_cmp_idx",
                      "col_cmp_idx"):
                torch.testing.assert_close(getattr(g[l][1], f),
                                           getattr(w, f), rtol=0, atol=0)


def test_hot_dense_shard_is_the_block_columns(small_graph, tmp_path):
    """A part's column shards of D and D^T, built from the cached COO,
    are the whole blocks' columns, bit for bit, at float32 and bfloat16;
    ``k % P`` must be 0."""
    s = _setup(small_graph)
    spec = s["tcfg"].hot_spec
    cache = str(tmp_path / "hot.npz")
    for dtype in (torch.float32, torch.bfloat16):
        d, dt = thd.build_hot_dense_cached(s["lap"], spec, dtype, "cpu",
                                           cache_path=cache)
        for p in range(N_PARTS):
            ksh = spec.k // N_PARTS
            ds, dts = thd.build_hot_dense_shard(s["lap"], spec, p, N_PARTS,
                                                dtype, "cpu", cache)
            cols = slice(p * ksh, (p + 1) * ksh)
            torch.testing.assert_close(ds, d[:, cols], rtol=0, atol=0)
            torch.testing.assert_close(dts, dt[:, cols], rtol=0, atol=0)
    with pytest.raises(ValueError, match="must divide by n_parts=3"):
        thd.build_hot_dense_shard(s["lap"], spec, 0, 3)


def test_k_not_divisible_by_parts_raises(small_graph):
    s = _setup(small_graph)
    for fn in (lambda: tsr.shard_resident_state(s["rg"], PartGroup(0, 3),
                                                "cpu"),
               lambda: tsr.build_sharded_resident(
                   s["lap"], s["tcfg"].hot_spec, s["rg"]["dense"],
                   s["rg"]["dense_t"], PartGroup(0, 3))):
        with pytest.raises(ValueError, match="k=256 .* must divide by "
                                             "n_parts=3"):
            fn()


def test_shard_bytes_divide_by_parts(small_graph):
    """A part's resident tables and blocks take 1/P of the replicated
    state's bytes, plus the last node range's padding; its feature shard
    1/P of the table."""
    s = _setup(small_graph)
    rg = s["rg"]
    whole = sum(np.asarray(rg[f]).nbytes for f in
                ("slot_of_node", "row_val", "col_val")) + sum(
        rg[f].nbytes for f in ("dense", "dense_t"))
    n, f = small_graph.feats.shape
    for p in range(N_PARTS):
        sh = tsr.shard_resident_state(rg, PartGroup(p, N_PARTS), "cpu")
        got = sum(sh.state_bytes().values())
        pad = 3 * 4 * (N_PARTS * sh.nsh - n) / N_PARTS
        assert whole / N_PARTS <= got <= whole / N_PARTS + pad + 12
        fs = tfc.PartShardedFeatures(small_graph.feats,
                                     PartGroup(p, N_PARTS))
        assert fs.table.nbytes == sh.nsh * f * 4


def _batches(graph, lap, n=3):
    """Three batches' input nodes and masks, the last one's mask half
    cleared (masked rows read zeros whoever holds them)."""
    cfg = tlad.SamplerConfig(batch_size=32, samp_num=64, orders=(1, 1),
                             num_nodes=lap.shape[0],
                             num_classes=graph.num_classes)
    out = []
    for i in range(n):
        mb = tlad.ladies_sample(cfg, 7 + i,
                                graph.train_nodes[32 * i:32 * (i + 1)], lap,
                                graph.labels)
        mask = mb.input_mask.copy()
        if i == n - 1:
            mask[::2] = 0.0
        out.append(dataclasses.replace(mb, input_mask=mask))
    return out


def _placements(graph, lap, strategy):
    """Both packages' placements of 10% of the nodes over the parts
    (small buffers, so host rows stay live)."""
    n = lap.shape[0]
    per_dev = n // 10
    out = []
    for eng in (jeng, teng):
        if strategy == "naive":
            out.append(eng.naive_placement(n, per_dev=per_dev,
                                           num_devs=N_PARTS))
            continue
        prob = eng.compute_sample_prob(lap, graph.train_nodes, 2)
        if strategy == "pagraph":
            out.append(eng.pagraph_placement(
                graph.train_nodes, lap, prob, num_devs=N_PARTS,
                num_conv_layers=2, per_dev=per_dev))
        else:
            out.append(eng.greedy_placement(prob, per_dev=per_dev,
                                            num_devs=N_PARTS))
    np.testing.assert_array_equal(out[1].device_id_of_nodes,
                                  out[0].device_id_of_nodes)
    return out


def _gather_all(make, mbs):
    """Every part's gathers of ``mbs`` (one source a part thread)."""
    def body(part):
        src = make(part)
        return [src.gather(torch.from_numpy(mb.input_nodes),
                           torch.from_numpy(mb.input_mask),
                           src.plan(mb)).numpy() for mb in mbs], src
    return run_parts(N_PARTS, body)


def _table(feats, dtype):
    return torch.from_numpy(feats).to(dtype).float().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_part_sharded_gather_is_the_host_gather(small_graph, dtype):
    lap = build_laplacian(small_graph.adj_full, "graphsage")
    mbs = _batches(small_graph, lap)
    got = _gather_all(lambda part: tfc.PartShardedFeatures(
        small_graph.feats, part, dtype), mbs)
    table = _table(small_graph.feats, dtype)
    for p, (xs, src) in enumerate(got):
        for x, mb in zip(xs, mbs):
            want = table[mb.input_nodes] * mb.input_mask[:, None]
            np.testing.assert_array_equal(x, want)
            np.testing.assert_array_equal(
                src.host_gather(mb.input_nodes, mb.input_mask).numpy(), want)
        assert src.stats["batches"] == len(mbs)
    assert sum(src.stats["rows_local"] for _, src in got) == sum(
        int(mb.input_mask.sum()) for mb in mbs)


@pytest.mark.parametrize("strategy", ["greedy", "naive", "pagraph"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_part_cached_gather_is_the_host_gather(small_graph, strategy,
                                               dtype):
    """Every part's gather equals ``feats[input_nodes] * mask`` exactly
    (the table rounded to ``dtype``), with rows from its own buffer, the
    other parts' and the host."""
    lap = build_laplacian(small_graph.adj_full, "graphsage")
    _, pl = _placements(small_graph, lap, strategy)
    mbs = _batches(small_graph, lap)
    got = _gather_all(lambda part: tfc.PartCachedFeatures(
        small_graph.feats, pl, part, dtype), mbs)
    table = _table(small_graph.feats, dtype)
    for xs, src in got:
        for x, mb in zip(xs, mbs):
            assert x.dtype == np.float32
            want = table[mb.input_nodes] * mb.input_mask[:, None]
            np.testing.assert_array_equal(x, want)
            np.testing.assert_array_equal(
                src.host_gather(mb.input_nodes, mb.input_mask).numpy(), want)
        st = src.stats
        assert st["rows_local"] + st["rows_peer"] + st["rows_host"] == sum(
            int(mb.input_mask.sum()) for mb in mbs)
        assert st["rows_host"] > 0 and st["rows_local"] + st["rows_peer"] > 0
    # each buffered row has one owner among the parts
    assert sum(src.stats["rows_local"] for _, src in got) == \
        got[0][1].stats["rows_local"] + got[0][1].stats["rows_peer"]


@pytest.mark.parametrize("strategy", ["greedy", "naive", "pagraph"])
def test_canonical_owner_map_single_owner(small_graph, strategy):
    """The owner and slot maps are the JAX package's; every buffered node
    has exactly one owner, which holds it at its slot."""
    lap = build_laplacian(small_graph.adj_full, "graphsage")
    jpl, tpl = _placements(small_graph, lap, strategy)
    jc = jfc.PartCachedFeatures(small_graph.feats, jpl)
    srcs = [tfc.PartCachedFeatures(small_graph.feats, tpl,
                                   PartGroup(p, N_PARTS))
            for p in range(N_PARTS)]
    om, sm = srcs[0].owner_map, srcs[0].slot_map
    np.testing.assert_array_equal(om, jc._owner_map)
    buffered = np.flatnonzero(om >= 0)
    np.testing.assert_array_equal(sm[buffered], jc._slot_map[buffered])
    np.testing.assert_array_equal(
        tpl.device_id_of_nodes[om[buffered], buffered], om[buffered])
    for p, src in enumerate(srcs):
        mine = buffered[om[buffered] == p]
        np.testing.assert_array_equal(
            src.buffer[torch.from_numpy(sm[mine])].numpy(),
            small_graph.feats[mine])
    with pytest.raises(ValueError, match="4 buffers for 2 parts"):
        tfc.PartCachedFeatures(small_graph.feats, tpl, PartGroup(0, 2))


@pytest.mark.parametrize("dp,parts", [(2, 2), (3, 2), (1, 2)])
def test_composed_locality_skew_wraps_like_jax(small_graph, dp, parts):
    """Composed mode with locality sampling: the placement has one skew
    list a part, and data rank d samples with list ``d % parts``, the JAX
    pipeline's rule (``per_rank_skew[rank % len(per_rank_skew)]``). Two
    data ranks with one list each sample the JAX pipeline's batches. The
    JAX pipeline's constructor accepts only one list a data rank, so
    where the counts differ it is given the lists its rule picks, in
    data-rank order."""
    import scipy.sparse as sp

    from gnn_tpu.sampling import pipeline as jpl
    from gnn_tpu_torch.sampling import pipeline as tpl
    from tests.test_torch_sampler import _cfgs, assert_same_batch
    lap, jcfg, tcfg = _cfgs(small_graph, "resident", True)
    n = lap.shape[0]
    adj = small_graph.adj_full + sp.eye(n)
    skews = []
    for eng in (jeng, teng):
        pl = eng.create_placement(lap, small_graph.train_nodes,
                                  per_dev=n // 5, num_devs=parts,
                                  num_conv_layers=2, alpha=0.0)
        skews.append(eng.get_per_rank_skewed_nodes(adj, pl, (1, 1)))
    jcfg = dataclasses.replace(jcfg, scale_factor=4.0)
    tcfg = dataclasses.replace(tcfg, scale_factor=4.0)
    targets = small_graph.train_nodes[:64 * dp]
    jp = jpl.BatchPipeline(jcfg, lap, small_graph.labels, world_size=dp,
                           pool_num=2, seed=3, per_rank_skew=[
                               skews[0][d % parts] for d in range(dp)])
    tps = [tpl.BatchPipeline(tcfg, lap, small_graph.labels, pool_num=2,
                             per_rank_skew=skews[1], seed=3, world_size=dp,
                             rank=r) for r in range(dp)]
    try:
        (group,) = list(jp._step_groups(targets, None, 0))
        for r, tp in enumerate(tps):
            (got,) = list(tp.train_epoch(targets, epoch=0))
            assert_same_batch(got, group[r])
            share = tp.skew_share(got)
            mask = np.zeros(n, bool)
            mask[skews[1][r % parts][0]] = True
            assert share == float(mask[got.input_nodes[: got.n_input]]
                                  .mean())
    finally:
        for tp in tps:
            tp.close()
        jp.pool.shutdown(wait=True, cancel_futures=True)
