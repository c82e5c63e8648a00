"""The published GAT of the port (``gatv1``, arXiv:1710.10903): its
additive edge-stream attention, its hot-block attention, the model
against the benchmark's plain reference, the split of the score source
out of the hot-block attention, its refusals and its counters.

* The additive ``*_ref`` modes of `gnn_tpu_torch.ops.esattn` against a
  direct computation over the dense ``[H, R, C]`` score grid of the same
  edges (each row's self edge left out): row max, terms and the
  gradients of el, er and v. The rowmax identity ``max_c lrelu(el + er_c)
  = lrelu(el + max_c er_c)`` holds exactly.
* The port's ``gatv1`` (2 hidden heads of 8, 3 output heads of 5
  classes, so that one head width is not a multiple of 4) on a resident
  batch, with the hot block and stream tiles (the ``*_ref`` functions)
  or the cold COO, against ``portbench/reference/model_gatv1.py`` on
  logits, loss and every parameter's gradient, dropout on.
* ``gat``'s hot path gives bit-equal results before and after the score
  source was split out (a frozen copy of the function as it was).
* Unported combinations raise ``NotImplementedError``; the host counts
  the attention work; eager steps span the additive attention.
* On a card (``-m cuda``; this module imports no JAX, so ``pytest
  --noconftest -m cuda`` runs it there): the additive CUDA kernels
  against the ``*_ref`` modes, one launch an entry point, and the
  grouped dispatch's G = 8 replays against G = 1 eager steps.
"""
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gnn_tpu_torch.data.synthetic import make_powerlaw_graph
from gnn_tpu_torch.models import gat as tgat
from gnn_tpu_torch.ops import edgestream as tes
from gnn_tpu_torch.ops import esattn as tea
from gnn_tpu_torch.ops.hotdense import HotSpec, _take_rows_fill, \
    build_hot_dense
from gnn_tpu_torch.ops.residentgraph import ResidentGraph, \
    build_resident_graph
from gnn_tpu_torch.placement.engine import compute_sample_prob
from gnn_tpu_torch.sampling.ladies import SamplerConfig, ladies_sample
from gnn_tpu_torch.train.loss import masked_loss
from gnn_tpu_torch.train.stepfns import prepare_adjs, to_device_batch
from gnn_tpu_torch.utils.normalize import build_laplacian

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_sampler_width import port_sampler_width  # noqa: E402

SLOPE = tgat.GATV1_SLOPE
ORDERS = (1, 1, 1)
NHID, HIDDEN_HEADS, OUTPUT_HEADS, CLASSES, FEATS = 16, 2, 3, 5, 12

# the additive modes against the dense grid: float32 sums of the same
# terms in another order (index_add_ against a dense reduction), rows of
# at most a few dozen edges, so the sums agree to a few ulps; 1e-5 of
# the magnitude-1 values leaves room without hiding a wrong edge
MODE_TOL = dict(rtol=1e-5, atol=1e-5)
# the model against the reference: three layers of float32 sums in
# other orders (the hot part's dense matmul and masked reductions
# against the reference's per-edge index_add_); the logits (of order 1)
# agree to 9e-8 absolute, so atol 1e-6 leaves ten times that, and rtol
# 1e-5 holds the larger ones
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
# gradients: the same sums through the backward; they agree to 2.2e-8
# absolute against entries up to 0.065, and atol 1e-6 leaves room for
# the cancellations of the leaves near zero (a_dst, whose gradient comes
# only from LeakyReLU's asymmetry)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


# --- the additive modes against a direct computation ----------------------

def _additive_case(seed=0, nr=256, nc=384, H=3, d=5, nnz=1500):
    """Random tiles over a ``nr x nc`` layer with a self column per row,
    some self edges in the tiles, a row without cold edges (row 3) and a
    row whose only cold edge is its self edge (row 5): ``(tiles, el, er,
    v, self_pos, mask)`` with ``mask`` the dense ``[nr, nc]`` pattern of
    the counted edges (self edges out)."""
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, nr, nnz)
    cols = rng.randint(0, nc, nnz)
    self_pos = rng.permutation(nc)[:nr].astype(np.int32)
    # self edges of a few rows ride in the tiles
    extra = rng.choice(nr, 20, replace=False)
    rows = np.concatenate([rows, extra, [5]])
    cols = np.concatenate([cols, self_pos[extra], [self_pos[5]]])
    keep = (rows != 3) & ((rows != 5) | (cols == self_pos[5]))
    rows, cols = rows[keep], cols[keep]
    _, ui = np.unique(rows * nc + cols, return_index=True)
    rows, cols = rows[ui], cols[ui]
    tiles = tes.pack_edge_tiles(rows, cols, nr, nc, bm=128, bk=128,
                                ecap=128)
    mask = np.zeros((nr, nc), bool)
    mask[rows, cols] = True
    mask[np.arange(nr), self_pos] = False
    el = rng.randn(nr, H).astype(np.float32)
    er = rng.randn(nc, H).astype(np.float32)
    v = rng.randn(nc, H * d).astype(np.float32)
    return tiles, el, er, v, self_pos, mask


def _t(tiles, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (tiles.coords, tiles.blk_rc, tiles.off,
                           tiles.t_order))


def _dense_terms(el, er, v, mask, rm):
    """``(den, num)`` over the dense ``[H, R, C]`` grid of additive
    scores, masked to the counted edges."""
    H = el.shape[1]
    s = F.leaky_relu(el.t()[:, :, None] + er.t()[:, None, :], SLOPE)
    e = torch.where(mask[None], torch.exp(s - rm.t()[:, :, None]),
                    torch.zeros(()))
    vh = v.reshape(v.shape[0], H, -1).transpose(0, 1)
    num = torch.matmul(e, vh).transpose(0, 1).reshape(el.shape[0], -1)
    return e.sum(2).t(), num


def test_additive_refs_match_the_dense_grid():
    tiles, el, er, v, self_pos, mask = _additive_case()
    t = _t(tiles)
    elt, ert, vt = (torch.from_numpy(a) for a in (el, er, v))
    sp = torch.from_numpy(self_pos)
    mk = torch.from_numpy(mask)
    kw = dict(slope=SLOPE, bm=128, bk=128)
    m = tea.cold_additive_rowmax_ref(*t[:3], elt, ert, sp, **kw)
    s = F.leaky_relu(elt.t()[:, :, None] + ert.t()[:, None, :], SLOPE)
    want = torch.where(mk[None], s, torch.full((), float("-inf"))).amax(2)
    has = mk.any(1)
    assert not has[3] and not has[5]
    torch.testing.assert_close(m[has], want.t()[has], rtol=0, atol=0)
    assert (m[~has] == tea.NEG_SENTINEL).all()
    # the rowmax identity: LeakyReLU is monotone
    er_max = torch.where(mk[None], ert.t()[:, None, :],
                         torch.full((), float("-inf"))).amax(2).t()
    torch.testing.assert_close(
        m[has], F.leaky_relu(elt + er_max, SLOPE)[has], rtol=0, atol=0)
    # terms and gradients at a finite row max
    rm = torch.where(has[:, None], m, torch.zeros(()))
    g = np.random.RandomState(1)
    wd = torch.from_numpy(g.randn(*el.shape).astype(np.float32))
    wn = torch.from_numpy(g.randn(el.shape[0], v.shape[1]).astype(
        np.float32))
    got_leaves = [a.clone().requires_grad_() for a in (elt, ert, vt)]
    den, num = tea.cold_terms(*t, (*got_leaves[:2], sp), got_leaves[2],
                              rm, **kw)
    ((den * wd).sum() + (num * wn).sum()).backward()
    want_leaves = [a.clone().requires_grad_() for a in (elt, ert, vt)]
    d_den, d_num = _dense_terms(*want_leaves, mk, rm)
    ((d_den * wd).sum() + (d_num * wn).sum()).backward()
    for name, a, b in (("den", den, d_den), ("num", num, d_num)):
        torch.testing.assert_close(a, b.detach(), **MODE_TOL, msg=name)
    for name, a, b in zip(("d el", "d er", "dv"), got_leaves, want_leaves):
        torch.testing.assert_close(a.grad, b.grad, **MODE_TOL, msg=name)
    # the rows without a counted edge read exact zeros
    assert (den[~has] == 0).all() and (num[~has] == 0).all()
    assert (got_leaves[0].grad[~has] == 0).all()


def test_additive_backward_modes_match_autograd_of_the_terms():
    """``add_bwd_q`` and ``add_bwd_kv`` called alone give what the terms'
    backward gives, including the LeakyReLU's slope on negative
    scores."""
    tiles, el, er, v, self_pos, mask = _additive_case(seed=2, H=2, d=4)
    t = _t(tiles)
    elt, ert, vt = (torch.from_numpy(a) for a in (el, er, v))
    sp = torch.from_numpy(self_pos)
    kw = dict(slope=SLOPE, bm=128, bk=128)
    m = tea.cold_additive_rowmax_ref(*t[:3], elt, ert, sp, **kw)
    rm = torch.where(m > tea.NEG_SENTINEL / 2, m, torch.zeros(()))
    g = torch.Generator().manual_seed(4)
    gd = torch.randn(el.shape, generator=g)
    gn = torch.randn((el.shape[0], v.shape[1]), generator=g)
    u = elt[:, :, None] + ert.t()[None]
    assert (u[torch.from_numpy(mask)[:, None, :].expand_as(u)] < 0).any()
    d_el = tea.cold_additive_bwd_q_ref(*t, elt, ert, sp, vt, rm, gd, gn,
                                       **kw)
    d_er, dv = tea.cold_additive_bwd_kv_ref(*t, elt, ert, sp, vt, rm, gd,
                                            gn, **kw)
    leaves = [a.clone().requires_grad_() for a in (elt, ert, vt)]
    den, num = _dense_terms(*leaves, torch.from_numpy(mask), rm)
    ((den * gd).sum() + (num * gn).sum()).backward()
    for name, a, b in (("d el", d_el, leaves[0].grad),
                       ("d er", d_er, leaves[1].grad),
                       ("dv", dv, leaves[2].grad)):
        torch.testing.assert_close(a, b, **MODE_TOL, msg=name)


# --- the model against the plain reference --------------------------------

class Resident:
    """A small graph's resident state (bfloat16 hot block, as the cell's)
    and its sampler configuration, stream tiles on or off."""

    def __init__(self, stream: bool, hot_k: int = 512, seed: int = 0):
        self.g = make_powerlaw_graph(num_nodes=1500, avg_degree=10,
                                     num_feats=FEATS, num_classes=CLASSES,
                                     seed=seed)
        self.lap = build_laplacian(self.g.adj_full, "gatv1")
        prob = compute_sample_prob(self.lap, self.g.train_nodes,
                                   len(ORDERS))
        self.spec = HotSpec.from_sample_prob(prob, hot_k)
        d, dt = build_hot_dense(self.lap, self.spec, torch.bfloat16, "cpu")
        self.host = build_resident_graph(self.lap, self.spec, d, dt,
                                         val_dtype="bfloat16")
        self.rg = ResidentGraph.from_host(self.host, "cpu")
        self.cfg = SamplerConfig(
            batch_size=64, samp_num=128, orders=ORDERS,
            num_nodes=self.lap.shape[0], num_classes=CLASSES,
            adj_format="resident", hot_spec=self.spec,
            resident_val_free=self.host["val_free"],
            resident_stream_tiles=stream)

    def batch(self, seed=5, first=0):
        port_sampler_width()
        mb = ladies_sample(self.cfg, seed,
                           self.g.train_nodes[first:first + 64], self.lap,
                           self.g.labels)
        batch = to_device_batch(mb, "cpu")
        return mb, batch, prepare_adjs(batch, self.rg)


@pytest.fixture(scope="module", params=[True, False],
                ids=["stream_tiles", "cold_coo"])
def resident(request):
    return Resident(request.param)


def _spec():
    return {"model": "gatv1", "heads": [HIDDEN_HEADS] * 2 + [OUTPUT_HEADS],
            "nhid": NHID, "n_feats": FEATS, "classes": CLASSES,
            "orders": list(ORDERS), "samp_num": 128, "loss": "sigmoid_bce"}


def _net(params):
    net = tgat.GATv1(FEATS, NHID, ORDERS, CLASSES, dropout=0.1,
                     hidden_heads=HIDDEN_HEADS, output_heads=OUTPUT_HEADS)
    net.load_state_dict(params, strict=True)
    return net


def test_gatv1_matches_the_plain_reference(resident):
    from portbench import program
    from portbench.reference import graph as refgraph
    from portbench.reference import model_gatv1
    from portbench.reference import numerics
    from portbench.reference import train as reftrain

    r = resident
    mb, batch, adjs = r.batch()
    spec = _spec()
    params = reftrain.make_params(spec, 17, "cpu")
    # the port: the hot block, and the cold residual through the stream
    # tiles' *_ref modes or the cold COO
    assert all(isinstance(a, tgat.HotDenseAdj) for a in adjs)
    assert all((a.es_rc is not None) == r.cfg.resident_stream_tiles
               for a in adjs)
    assert all(a.present_row_slots.shape[0] > 0 for a in adjs)
    net = _net(params)
    x = torch.from_numpy(r.g.feats)[batch.input_nodes.long()] * \
        batch.input_mask[:, None]
    gen = torch.Generator().manual_seed(23)
    out = net(x, adjs, batch.sampled_nodes, generator=gen)
    loss = masked_loss(out, batch.labels, batch.label_mask, True)
    loss.backward()
    # the reference, on the same batch from the same parameters and the
    # same dropout draws
    a = program.graph_arrays(r.g)
    rg = refgraph.RefGraph(a["indptr"], a["indices"], a["data"],
                           a["label_indptr"], a["label_indices"],
                           a["num_classes"], a["train_nodes"], norm="row",
                           hot_k=512, depth=len(ORDERS))
    (st,) = reftrain.prepare(spec, rg, [program.batch_view(mb, 0)],
                             r.g.feats, "cpu")
    ref_params = {k: v.clone().requires_grad_() for k, v in params.items()}
    rgen = torch.Generator().manual_seed(23)
    logits = model_gatv1.forward(
        ref_params, st["layers"], st["x"],
        lambda h, i: numerics.dropout(h, rgen, 0.1, st["caps"][i]), spec,
        "float32")
    ref_loss = reftrain.masked_loss(logits, st["labels"], spec)
    ref_loss.backward()
    n = logits.shape[0]
    torch.testing.assert_close(out[:n].detach(), logits.detach(),
                               **OUT_TOL)
    torch.testing.assert_close(loss.detach(), ref_loss.detach(), **OUT_TOL)
    grads = dict(net.named_parameters())
    for name, p in ref_params.items():
        torch.testing.assert_close(grads[name].grad, p.grad, **GRAD_TOL,
                                   msg=name)


def test_gatv1_self_edge_counts_once(resident):
    """A layer that already holds a row's self edge counts it once: the
    output is the same with the self edge planted into the hot mask as
    without (the graph itself has no self loops)."""
    r = resident
    _, batch, adjs = r.batch(seed=6)
    a = adjs[0]
    hot_rows = torch.nonzero(a.row_cmp_idx != (1 << 30))[:, 0]
    rows = hot_rows[:8]
    self_cols = batch.sampled_nodes[0].long()[rows]
    slots_r = a.present_row_slots.long()[a.row_cmp_idx.long()[rows]]
    slots_c = a.present_col_slots.long()[a.col_cmp_idx.long()[self_cols]]
    assert (a.dense[slots_r, slots_c] == 0).all()
    planted = a.dense.clone()
    planted[slots_r, slots_c] = 1
    g = torch.Generator().manual_seed(0)
    el = torch.randn(a.nrows, 2, generator=g)
    er = torch.randn(a.ncols, 2, generator=g)
    v = torch.randn(a.ncols, 6, generator=g)
    sp = tgat._self_pos(batch.sampled_nodes[0], a.nrows)
    want = tgat.hot_attention(a, tgat.AdditiveScores(el, er, sp), v)
    import dataclasses
    got = tgat.hot_attention(dataclasses.replace(a, dense=planted),
                             tgat.AdditiveScores(el, er, sp), v)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_gatv1_rows_attending_to_themselves_alone():
    """A row with no sampled edge attends to itself alone: its output is
    its own ``z`` (softmax of one term)."""
    r = Resident(True)
    _, batch, adjs = r.batch()
    a = adjs[0]
    empty = tes.pack_edge_tiles(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                a.nrows, a.ncols, bm=a.es_bm, bk=a.es_bk)
    import dataclasses
    c, rc, off, order = _t(empty)
    bare = dataclasses.replace(
        a, dense=torch.zeros_like(a.dense), es_coords=c, es_rc=rc,
        es_off=off, es_ord=order)
    g = torch.Generator().manual_seed(1)
    el = torch.randn(a.nrows, 2, generator=g)
    er = torch.randn(a.ncols, 2, generator=g)
    v = torch.randn(a.ncols, 6, generator=g)
    sp = tgat._self_pos(batch.sampled_nodes[0], a.nrows)
    out = tgat.hot_attention(bare, tgat.AdditiveScores(el, er, sp), v)
    torch.testing.assert_close(out, v[sp.long()], rtol=0, atol=0)


# --- gat's hot path: bit-equal across the split ---------------------------

def _hot_attention_before(adj, q_pad, k, v, n_heads):
    """``gat``'s hot-block attention as it was before the score source
    was split out (one rank: no part group), frozen for the bit-equality
    test below."""
    H = n_heads
    n_out = k.shape[1]
    d = n_out // H
    scale = tgat._scale(d)
    dev = k.device
    use_es = adj.es_rc is not None
    cold_empty = (not use_es) and adj.rows.shape[0] == 0
    sentinel = 1 << 30
    rh = adj.present_row_slots.shape[0]
    ch = adj.present_col_slots.shape[0]
    r_loc = adj.rowpos.index_select(0, adj.present_row_slots.long())
    c_loc = adj.colpos.index_select(0, adj.present_col_slots.long())
    n_hot_r = (adj.row_cmp_idx != sentinel).sum()
    n_hot_c = (adj.col_cmp_idx != sentinel).sum()
    row_ok = torch.arange(rh, device=dev) < n_hot_r
    col_ok = torch.arange(ch, device=dev) < n_hot_c
    d_rows = adj.dense.index_select(0, adj.present_row_slots.long())
    d_sub = d_rows.index_select(1, adj.present_col_slots.long())
    mask_hot = (d_sub != 0) & row_ok[:, None] & col_ok[None, :]

    def split(a):
        return a.reshape(a.shape[0], H, d).transpose(0, 1)

    qh = split(_take_rows_fill(q_pad, r_loc))
    kh = split(_take_rows_fill(k, c_loc))
    vh = split(_take_rows_fill(v, c_loc))
    s_hot = torch.where(mask_hot[None],
                        torch.matmul(qh, kh.transpose(1, 2)) * scale,
                        torch.full((), float("-inf"), device=dev))
    m_hot = s_hot.detach().amax(dim=2)
    if use_es:
        qs = q_pad * scale
        m_cold = tea.cold_rowmax(
            adj.es_coords, adj.es_rc, adj.es_off, (qs.detach(), k.detach()),
            n_heads=H, bm=adj.es_bm, bk=adj.es_bk)
        m_cold = torch.where(m_cold > tea.NEG_SENTINEL / 2, m_cold,
                             torch.full((), float("-inf"), device=dev))
    elif cold_empty:
        m_cold = torch.full((adj.nrows, H), float("-inf"), device=dev)
    else:
        rows_c, cols_c = adj.rows.long(), adj.cols.long()
        live = adj.vals.float() != 0
        s_cold = tgat._edge_scores(q_pad, k, rows_c, cols_c, live, H, scale)
        m_cold = tgat._segment_max(s_cold.detach(), rows_c, adj.nrows)
    m_hot_rows = _take_rows_fill(m_hot.t(), adj.row_cmp_idx,
                                 fill=float("-inf"))
    row_max = torch.maximum(m_cold, m_hot_rows)
    row_max = torch.where(torch.isfinite(row_max), row_max,
                          torch.zeros((), device=dev)).detach()
    rm_cmp = _take_rows_fill(row_max, r_loc)
    e = torch.exp(s_hot - rm_cmp.t()[:, :, None])
    den_hot, num_hot = e.sum(dim=2), torch.matmul(e, vh)
    if use_es:
        den_cold, num_cold = tea.cold_terms(
            adj.es_coords, adj.es_rc, adj.es_off, adj.es_ord, (qs, k), v,
            row_max, n_heads=H, bm=adj.es_bm, bk=adj.es_bk)
    elif cold_empty:
        den_cold = torch.zeros((adj.nrows, H), device=dev)
        num_cold = torch.zeros((adj.nrows, n_out), device=dev)
    else:
        att = (torch.exp(s_cold - _take_rows_fill(row_max, rows_c))
               * live[:, None])
        den_cold = att.new_zeros((adj.nrows, H)).index_add(0, rows_c, att)
        num_cold = tgat._edge_aggregate(att, rows_c, cols_c, v, adj.nrows,
                                        H)
    num_cold = num_cold.to(v.dtype)
    den = _take_rows_fill(den_hot.t(), adj.row_cmp_idx) + den_cold
    num = num_cold + _take_rows_fill(
        num_hot.transpose(0, 1).reshape(rh, n_out),
        adj.row_cmp_idx).to(v.dtype)
    den_e = torch.where(den > 0, den, torch.ones((), device=dev))
    return (num.reshape(adj.nrows, H, d) / den_e[:, :, None]).reshape(
        adj.nrows, n_out)


@pytest.mark.parametrize("H", [1, 2])
def test_gat_hot_path_bit_equal_across_the_split(resident, H):
    _, _, adjs = resident.batch(seed=8)
    a = adjs[1]
    g = torch.Generator().manual_seed(H)
    q = torch.randn(a.nrows, 16, generator=g)
    k = torch.randn(a.ncols, 16, generator=g)
    v = torch.randn(a.ncols, 16, generator=g)
    w = torch.randn(a.nrows, 16, generator=g)
    outs = []
    def after(adj, q_pad, k, v, n_heads):
        return tgat.hot_attention(adj, tgat.DotScores(q_pad, k, n_heads), v)
    for fn in (_hot_attention_before, after):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        y = fn(a, *leaves, H)
        (y * w).sum().backward()
        outs.append([y.detach()] + [t.grad for t in leaves])
    for name, x, y in zip(("y", "dq", "dk", "dv"), *outs):
        assert torch.equal(x, y), name


# --- refusals, counters, spans --------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--adj_format", "hot"], ["--adj_format", "coo"],
    ["--adj_format", "pattern"], ["--adj_format", "blocked"],
    ["--n_devices", "2"], ["--feature_cache"],
    ["--n_devices", "1", "--resident_parts", "2"],
    ["--adj_format", "coo", "--steps_per_dispatch", "4"]])
def test_unported_combinations_raise(extra):
    from gnn_tpu_torch import cli
    args = cli.build_parser().parse_args(["--model", "gatv1"] + extra)
    cli.resolve_adj_format(args)
    with pytest.raises(NotImplementedError, match="ROADMAP.md: gatv1-"):
        cli._check_ported(args)


def test_the_model_refuses_what_it_cannot_run():
    with pytest.raises(NotImplementedError):
        tgat.GATv1(FEATS, NHID, (1, 0, 1), CLASSES)
    net = tgat.GATv1(FEATS, NHID, (1,), CLASSES, hidden_heads=2,
                     output_heads=3)
    from gnn_tpu_torch.ops.sparse import PatternAdj
    pat = PatternAdj.__new__(PatternAdj)
    with pytest.raises(NotImplementedError, match="gatv1-formats"):
        net.layers[0](torch.zeros(4, FEATS), pat, torch.zeros(4))


def test_defaults_and_heads():
    from gnn_tpu_torch import cli
    from gnn_tpu_torch.models.gnn import build_model
    args = cli.build_parser().parse_args(["--model", "gatv1"])
    assert cli.resolve_training_defaults(args, 50) == 50
    assert args.lr == 0.005
    net = build_model("gatv1", 1024, ORDERS, 41, n_feats=602)
    assert tgat.attention_heads(net) == [4, 4, 6]
    assert [(c.n_heads, c.d) for c in net.layers] == [(4, 256), (4, 256),
                                                      (6, 41)]
    assert [c.res is not None for c in net.layers] == [False, True, False]
    assert tgat.attention_heads(build_model("gat", 16, ORDERS, 5, 12)) == \
        [1, 1, 1]
    assert tgat.attention_heads(build_model("graphsage", 16, ORDERS, 5,
                                            12)) == []


def test_host_counts_and_the_eager_span():
    """Counters ``attn.dense_entries`` (0: the hot part runs on its live
    entries, which the card counts) and ``attn.cold_slots`` a batch, and
    the span ``attn.additive`` of each eager layer."""
    from gnn_tpu_torch.utils.timing import RECORDER
    r = Resident(True)
    mb, batch, adjs = r.batch()
    key = "gatv1-test"
    prev, RECORDER.epoch = RECORDER.epoch, key
    try:
        net = _net(tgat.GATv1(FEATS, NHID, ORDERS, CLASSES,
                              hidden_heads=HIDDEN_HEADS,
                              output_heads=OUTPUT_HEADS).state_dict())
        tgat.AttentionCounts.of(net).staged(mb)
        with torch.no_grad():
            net.eval()
            net(torch.from_numpy(r.g.feats)[batch.input_nodes.long()],
                adjs, batch.sampled_nodes)
    finally:
        RECORDER.epoch = prev
    slots = sum(a.es_coords.size for a in mb.adjs)
    assert slots > 0
    assert RECORDER.total("attn.dense_entries", [key], "count") == 0
    assert RECORDER.total("attn.cold_slots", [key], "count") == slots
    assert RECORDER.total("attn.additive", [key], "calls") == len(ORDERS)


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    return torch.device("cuda")


def _additive_kernels(fn):
    """The additive CUDA kernels ``fn()`` launches, by name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "edge_attention_additive_kernel" in e.name]


# (H, d, nnz): the hidden layers' 4 x 256 (32 floats a lane), the output
# layer's 6 x 41 (the scalar path), one head
CARD_CASES = [(4, 256, 3000), (6, 41, 3000), (1, 8, 1500)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,d,nnz", CARD_CASES)
def test_cuda_additive_kernels_match_the_plain_versions(cuda_device, H, d,
                                                        nnz):
    tiles, el, er, v, self_pos, _ = _additive_case(seed=H, H=H, d=d,
                                                   nnz=nnz)
    dev = cuda_device
    t = _t(tiles, dev)
    elt, ert, vt = (torch.from_numpy(a).to(dev) for a in (el, er, v))
    sp = torch.from_numpy(self_pos).to(dev)
    kw = dict(slope=SLOPE, bm=128, bk=128)
    before = dict(tea.launches)
    m = tea.cold_rowmax(*t[:3], (elt, ert, sp), **kw)
    # the row max is exact: its scores are one add and one multiply
    torch.testing.assert_close(
        m, tea.cold_additive_rowmax_ref(*t[:3], elt, ert, sp, **kw),
        rtol=0, atol=0)
    rm = torch.where(m > tea.NEG_SENTINEL / 2, m, torch.zeros_like(m))
    g = torch.Generator(device=dev).manual_seed(3)
    gd = torch.randn(rm.shape, generator=g, device=dev)
    gn = torch.randn((el.shape[0], v.shape[1]), generator=g, device=dev)
    leaves = [a.clone().requires_grad_() for a in (elt, ert, vt)]
    den, num = tea.cold_terms(*t, (*leaves[:2], sp), leaves[2], rm, **kw)
    ((den * gd).sum() + (num * gn).sum()).backward()
    want = tea.cold_additive_terms_ref(*t, elt, ert, sp, vt, rm, **kw)
    d_el = tea.cold_additive_bwd_q_ref(*t, elt, ert, sp, vt, rm, gd, gn,
                                       **kw)
    d_er, dv = tea.cold_additive_bwd_kv_ref(*t, elt, ert, sp, vt, rm, gd,
                                            gn, **kw)
    torch.cuda.synchronize()
    # float32 sums in another order (shared-memory int atomics set the
    # kernel's) over rows of at most a few dozen edges
    tol = dict(rtol=1e-4, atol=1e-5)
    for name, a, b in (("den", den, want[0]), ("num", num, want[1]),
                       ("d el", leaves[0].grad, d_el),
                       ("d er", leaves[1].grad, d_er),
                       ("dv", leaves[2].grad, dv)):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, **tol, msg=name)
    for key in ("add_rowmax", "add_terms", "add_bwd_q", "add_bwd_kv"):
        assert tea.launches[key] == before.get(key, 0) + 1, key


@pytest.mark.cuda
def test_cuda_additive_kernels_have_a_name_of_their_own(cuda_device):
    """The four additive entry points launch one kernel each, named
    ``edge_attention_additive_kernel`` (the trace tells them from the
    dot product's ``edge_attention_kernel``)."""
    tiles, el, er, v, self_pos, _ = _additive_case(seed=9, H=4, d=8)
    dev = cuda_device
    t = _t(tiles, dev)
    elt, ert, vt = (torch.from_numpy(a).to(dev) for a in (el, er, v))
    sp = torch.from_numpy(self_pos).to(dev)
    kw = dict(slope=SLOPE, bm=128, bk=128)
    rm = torch.zeros(elt.shape, device=dev)
    gd, gn = torch.ones_like(rm), torch.ones(el.shape[0], v.shape[1],
                                             device=dev)

    def all_four():
        ops = (elt, ert, sp)
        tea.cold_rowmax(*t[:3], ops, **kw)
        tea.cold_terms(*t, ops, vt, rm, **kw)
        tea.cold_backward("bwd_q", *t, ops, vt, rm, gd, gn, **kw)
        tea.cold_backward("bwd_kv", *t, ops, vt, rm, gd, gn, **kw)
    all_four()
    names = _additive_kernels(all_four)
    assert len(names) == 4, names
    assert not any("edge_attention_kernel" in n for n in names), names


@pytest.mark.cuda
def test_cuda_graph_replay_matches_eager_steps(cuda_device):
    """On the card, dropout on: an epoch of G = 8 (replays of an 8-step
    graph, the additive kernels launched inside them) against the same
    epoch of eager steps from the same state; every step loss within
    1e-5 relative, the additive kernels recorded four a layer a step and
    the hot part's five (the mask pass and its four modes)."""
    from gnn_tpu_torch.sampling.pipeline import BatchPipeline
    from gnn_tpu_torch.train.trainer import Trainer
    r = Resident(True)
    init = tgat.GATv1(FEATS, NHID, ORDERS, CLASSES, hidden_heads=2,
                      output_heads=3).state_dict()
    targets = r.g.train_nodes[: 64 * 10]

    def trainer(g):
        return Trainer(_net(init), BatchPipeline(r.cfg, r.lap, r.g.labels,
                                                 pool_num=2, seed=3),
                       r.g.feats, lr=0.005, sigmoid_loss=True, seed=3,
                       resident_graph=r.host, device="cuda",
                       steps_per_dispatch=g)
    eager, grouped = trainer(1), trainer(8)
    port_sampler_width()
    try:
        for e in range(2):
            want = eager.train_epoch(targets, epoch=e).step_losses
            got = grouped.train_epoch(targets, epoch=e).step_losses
            np.testing.assert_allclose(got, want, rtol=1e-5)
        rep = grouped._dispatch.replayed_launches()
        steps = sum(c["steps"] * c["replays"]
                    for c in grouped._dispatch.captures)
        assert steps == 2 * 10
        want = {f"esattn.add_{k}": len(ORDERS) * steps
                for k in ("rowmax", "terms", "bwd_q", "bwd_kv")}
        # the hot part on its live entries: the mask pass and four modes
        want.update({f"hotattn.{k}": len(ORDERS) * steps
                     for k in ("mask", "rowmax", "terms", "bwd_row",
                               "bwd_col")})
        assert rep == want
    finally:
        eager.pipeline.close()
        grouped.pipeline.close()
