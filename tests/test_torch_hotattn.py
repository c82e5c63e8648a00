"""The hot part on its live entries (`gnn_tpu_torch.ops.hotattn`,
``csrc/hot_attention.cu``), additive and dot-product: the plain version
of each mode against a direct computation over the dense ``[H, rh, ch]``
grid and its autograd, the model's hot-block attention against the dense
route it replaced, the dot product's dense grid on a part's shard, the
refusal of a part's shard by gatv1, and the counters.

* The mask: :func:`hotattn.live_masks_ref` is the dense route's mask
  (present pads that repeat slot 0 and each row's own column left out),
  packed into words both ways.
* The four modes (rowmax exact; terms, bwd_row, bwd_col) and the
  autograd Function's gradients of ``el``, ``er`` and ``v`` on a grid
  with pad rows and columns, a row with no live entry, self columns and a
  score of exactly 0 (LeakyReLU's kink), at 4 and 6 heads, widths a
  multiple of 8 and 41.
* The four dot-product modes' plain versions and their autograd
  Function against the dense formula and its autograd (a hub row, a row
  with no live entry, pads that repeat slot 0; one head of 16, two of
  6), and gat's live grid against the dense grid on resident layers.
* `hot_attention` with the additive source against a frozen copy of the
  function as it was (the dense grid): close; bit-equal for the
  dot-product source, on one part (its plain versions are the grid's
  operations) and on a part's shard (the grid). gatv1 refuses a part's
  shard of the block.
* A net's `AttentionCounts` adds no dense entries where the hot part
  runs live (gat and gatv1 on one part), the live-entry counter adds ``H
  x`` the walked entries in training forwards only, and an epoch records
  it.
* On a card (``-m cuda``; this module imports no JAX, so ``pytest
  --noconftest -m cuda tests/test_torch_hotattn.py`` runs it there): the
  mask pass and the four additive kernels against the plain versions at
  gatv1's widths, the four dot kernels at gat's (one head of 512) on a
  skewed grid, their names in a trace beside K3/K4's unchanged number of
  calls, and the counter.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gnn_tpu_torch.data.synthetic import make_powerlaw_graph
from gnn_tpu_torch.models import gat as tgat
from gnn_tpu_torch.ops import hotattn
from gnn_tpu_torch.ops.hotdense import HotSpec, build_hot_dense
from gnn_tpu_torch.ops.residentgraph import ResidentGraph, \
    build_resident_graph
from gnn_tpu_torch.parallel.dist import PartGroup
from gnn_tpu_torch.placement.engine import compute_sample_prob
from gnn_tpu_torch.sampling.ladies import SamplerConfig, ladies_sample
from gnn_tpu_torch.train.stepfns import prepare_adjs, to_device_batch
from gnn_tpu_torch.utils.normalize import build_laplacian
from gnn_tpu_torch.utils.timing import RECORDER

SLOPE = tgat.GATV1_SLOPE
# float32 sums of the same terms in another order (the modes' dense
# reductions and matmuls against autograd's, or the kernels' sequential
# sums), rows of at most a few dozen entries of magnitude up to a few:
# they agree to a few ulps, and 1e-5 leaves room without hiding a wrong
# entry (one entry is 1e-2 of a row's sum or more)
MODE_TOL = dict(rtol=1e-5, atol=1e-5)
# (heads, features a head): gatv1's hidden and output layers' heads at
# widths that take the vector path (a multiple of 8) and the scalar path
CASES = [(4, 8), (4, 41), (6, 8), (6, 41)]


# --- a present grid with every case the mask must handle ------------------

@dataclasses.dataclass
class Grid:
    dense: torch.Tensor       # [k, k] bfloat16 block
    prs: torch.Tensor         # [rh] present row slots, pads repeat slot 0
    pcs: torch.Tensor         # [ch]
    cmp_r: torch.Tensor       # [k] each slot's present row (-1: none)
    cmp_c: torch.Tensor       # [k]
    own: torch.Tensor         # [rh] each row's own column (ch + 5: none)
    mask: torch.Tensor        # [rh, ch] the dense route's mask
    n_r: int
    n_c: int


def _grid(seed=0, k=96, rh=48, ch=80, n_r=37, n_c=66):
    g = torch.Generator().manual_seed(seed)
    vals = torch.rand(k, k, generator=g) + 0.1
    dense = torch.where(torch.rand(k, k, generator=g) < 0.2, vals,
                        torch.zeros(())).to(torch.bfloat16)
    # slot 0 is a true present row and column, so the pads that repeat
    # it would count its entries twice if they were taken
    slots_r = torch.cat([torch.tensor([5, 0]), torch.randperm(
        k - 6, generator=g)[: n_r - 2] + 6])
    slots_c = torch.cat([torch.tensor([0]), torch.randperm(
        k - 1, generator=g)[: n_c - 1] + 1])
    prs = torch.cat([slots_r, torch.zeros(rh - n_r, dtype=torch.long)])
    pcs = torch.cat([slots_c, torch.zeros(ch - n_c, dtype=torch.long)])
    cmp_r = torch.full((k,), -1, dtype=torch.long)
    cmp_r[slots_r] = torch.arange(n_r)
    cmp_c = torch.full((k,), -1, dtype=torch.long)
    cmp_c[slots_c] = torch.arange(n_c)
    # row 3 has no edge to a present column
    dense[slots_r[3]] = 0
    # half the rows own a column they have an edge to, the rest none
    own = torch.full((rh,), ch + 5, dtype=torch.long)
    sub = dense[prs][:, pcs] != 0
    for i in range(0, n_r, 2):
        cols = torch.nonzero(sub[i, :n_c])[:, 0]
        if cols.numel():
            own[i] = cols[len(cols) // 2]
    mask = (sub & (torch.arange(rh) < n_r)[:, None]
            & (torch.arange(ch) < n_c)[None, :]
            & (torch.arange(ch)[None, :] != own[:, None]))
    return Grid(dense, prs.int(), pcs.int(), cmp_r.int(), cmp_c.int(),
                own.int(), mask, n_r, n_c)


def _operands(grid, H, d, seed=1):
    """el, er, v, a combined row max at or above the live max, cotangents,
    and one live entry of score exactly 0 a head."""
    g = torch.Generator().manual_seed(seed)
    rh, ch = grid.mask.shape
    el = torch.randn(rh, H, generator=g)
    er = torch.randn(ch, H, generator=g)
    v = torch.randn(ch, H * d, generator=g)
    r, c = torch.nonzero(grid.mask)[7]
    el[r] = -er[c]                       # u = el + er = 0 exactly
    s = _dense_scores(grid.mask, el, er)
    m = s.amax(2).t()
    rm = torch.where(torch.isfinite(m), m, torch.zeros(())) + torch.rand(
        rh, H, generator=g) * (torch.arange(rh) % 3 == 0)[:, None]
    gden = torch.randn(rh, H, generator=g)
    gnum = torch.randn(rh, H * d, generator=g)
    return el, er, v, rm, gden, gnum


def _dense_scores(mask, el, er):
    """``[H, rh, ch]`` additive scores, -inf off the mask."""
    return torch.where(mask[None], F.leaky_relu(
        el.t()[:, :, None] + er.t()[:, None, :], SLOPE),
        torch.full((), float("-inf")))


def _dense_terms(mask, el, er, v, rm):
    """The dense route's terms: ``(den [rh, H], num [rh, H d])``."""
    H = el.shape[1]
    e = torch.exp(_dense_scores(mask, el, er) - rm.t()[:, :, None])
    num = torch.matmul(e, v.reshape(v.shape[0], H, -1).transpose(0, 1))
    return e.sum(2).t(), num.transpose(0, 1).reshape(el.shape[0], -1)


def test_live_masks_are_the_dense_mask_packed_both_ways():
    grid = _grid()
    bits, bits_t, n_r, n_c = hotattn.live_masks(
        grid.dense, grid.prs, grid.pcs, grid.cmp_r, grid.cmp_c, grid.own)
    rh, ch = grid.mask.shape
    assert bits.dtype == torch.int32 and bits.shape == (rh, -(-ch // 32))
    assert bits_t.shape == (ch, -(-rh // 32))
    assert torch.equal(hotattn.unpack_bits(bits, ch), grid.mask)
    assert torch.equal(hotattn.unpack_bits(bits_t, rh), grid.mask.t())
    assert n_r.dtype == n_c.dtype == torch.int32
    assert torch.equal(n_r.long(), grid.mask.sum(1))
    assert torch.equal(n_c.long(), grid.mask.sum(0))
    # the cases are there: pad rows and columns empty, row 3 empty, own
    # columns out, a row whose every column is live elsewhere
    assert not grid.mask[grid.n_r:].any()
    assert not grid.mask[:, grid.n_c:].any()
    assert not grid.mask[3].any() and grid.mask[:grid.n_r].any(1).sum() > 30
    sub = grid.dense[grid.prs.long()][:, grid.pcs.long()] != 0
    dropped = sub[:grid.n_r, :grid.n_c] & ~grid.mask[:grid.n_r, :grid.n_c]
    assert dropped.sum() == (grid.own[:grid.n_r] < grid.n_c).sum() > 10
    assert torch.equal(hotattn.pack_bits(hotattn.unpack_bits(bits, ch)),
                       bits)


@pytest.mark.parametrize("H,d", CASES)
def test_rowmax_is_exact(H, d):
    grid = _grid(seed=H)
    bits, *_ = hotattn.live_masks_ref(grid.dense, grid.prs, grid.pcs,
                                      grid.cmp_r, grid.cmp_c, grid.own)
    el, er, *_ = _operands(grid, H, d)
    want = _dense_scores(grid.mask, el, er).amax(2).t()
    got = hotattn.rowmax_ref(bits, el, er, SLOPE)
    assert torch.isinf(got[3]).all() and (got[3] < 0).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("H,d", CASES)
def test_modes_match_the_dense_grid_and_its_autograd(H, d):
    grid = _grid(seed=10 + H)
    bits, bits_t, _, _ = hotattn.live_masks_ref(
        grid.dense, grid.prs, grid.pcs, grid.cmp_r, grid.cmp_c, grid.own)
    el, er, v, rm, gden, gnum = _operands(grid, H, d, seed=d)
    leaves = [t.clone().requires_grad_() for t in (el, er, v)]
    den, num = _dense_terms(grid.mask, *leaves, rm)
    ((den * gden).sum() + (num * gnum).sum()).backward()
    got_den, got_num = hotattn.terms_ref(bits, el, er, v, rm, SLOPE)
    d_el = hotattn.bwd_row_ref(bits, el, er, v, rm, gden, gnum, SLOPE)
    d_er, dv = hotattn.bwd_col_ref(bits_t, el, er, v, rm, gden, gnum, SLOPE)
    for name, a, b in (("den", got_den, den), ("num", got_num, num),
                       ("d el", d_el, leaves[0].grad),
                       ("d er", d_er, leaves[1].grad),
                       ("dv", dv, leaves[2].grad)):
        torch.testing.assert_close(a, b.detach(), **MODE_TOL, msg=name)
    # the row without a live entry adds nothing
    assert (got_den[3] == 0).all() and (got_num[3] == 0).all()
    assert (d_el[3] == 0).all()


@pytest.mark.parametrize("H,d", CASES)
def test_the_function_differentiates_as_the_dense_grid(H, d):
    grid = _grid(seed=20 + d)
    bits, bits_t, _, _ = hotattn.live_masks(
        grid.dense, grid.prs, grid.pcs, grid.cmp_r, grid.cmp_c, grid.own)
    el, er, v, rm, gden, gnum = _operands(grid, H, d, seed=H + d)
    outs = []
    for fn in (lambda a, b, c: _dense_terms(grid.mask, a, b, c, rm),
               lambda a, b, c: hotattn.terms(bits, bits_t, a, b, c, rm,
                                             SLOPE)):
        leaves = [t.clone().requires_grad_() for t in (el, er, v)]
        den, num = fn(*leaves)
        ((den * gden).sum() + (num * gnum).sum()).backward()
        outs.append([den.detach(), num.detach()]
                    + [t.grad for t in leaves])
    for name, a, b in zip(("den", "num", "d el", "d er", "dv"), *outs):
        torch.testing.assert_close(b, a, **MODE_TOL, msg=name)


def test_the_kink_takes_the_slope():
    """A live score of exactly 0 takes LeakyReLU's slope in ``d el``, as
    torch's derivative at 0 does: one row, one live entry."""
    mask = torch.zeros(2, 32, dtype=torch.bool)
    mask[0, 4] = True
    bits, bits_t = hotattn.pack_bits(mask), hotattn.pack_bits(mask.t())
    el = torch.tensor([[0.5], [0.0]])
    er = torch.zeros(32, 1)
    er[4] = -0.5
    v = torch.ones(32, 1)
    rm = torch.zeros(2, 1)
    gden, gnum = torch.ones(2, 1), torch.zeros(2, 1)
    d_el = hotattn.bwd_row_ref(bits, el, er, v, rm, gden, gnum, SLOPE)
    d_er, _ = hotattn.bwd_col_ref(bits_t, el, er, v, rm, gden, gnum, SLOPE)
    # e = exp(0 - 0) = 1, ds = 1, dx = slope
    assert d_el[0, 0].item() == float(np.float32(SLOPE))
    assert d_er[4, 0].item() == float(np.float32(SLOPE))


# --- the dot-product modes -----------------------------------------------------

# (heads, features a head) of the dot modes: gat's one head, and two heads
# of a width off the vector path
DOT_CASES = [(1, 16), (2, 6)]
# the dot product's plain versions against autograd of the dense formula:
# float32 sums of a few dozen terms in another order
DOT_TOL = dict(rtol=1e-6, atol=1e-6)


def _dot_grid(seed):
    """:func:`_grid` with no own columns (the dot source has none) and a
    hub row (row 2 holds an edge to every true present column)."""
    grid = _grid(seed=seed)
    grid.dense[grid.prs[2].long(), grid.pcs[:grid.n_c].long()] = 1
    grid.own = torch.full_like(grid.own, -1)
    grid.mask = hotattn.unpack_bits(hotattn.live_masks_ref(
        grid.dense, grid.prs, grid.pcs, grid.cmp_r, grid.cmp_c, grid.own)[0],
        grid.mask.shape[1])
    return grid


def _dense_dot_scores(mask, q, k, H, scale):
    """``[H, rh, ch]`` dot-product scores, written out, -inf off the
    mask."""
    qh, kh = (t.reshape(t.shape[0], H, -1).transpose(0, 1) for t in (q, k))
    return torch.where(mask[None],
                       torch.einsum("hrd,hcd->hrc", qh, kh) * scale,
                       torch.full((), float("-inf")))


def _dense_dot_terms(mask, q, k, v, rm, H, scale):
    """The dense grid's terms, written out: ``(den [rh, H], num [rh, H
    d])``."""
    e = torch.exp(_dense_dot_scores(mask, q, k, H, scale)
                  - rm.t()[:, :, None])
    num = torch.einsum("hrc,hcd->hrd", e,
                       v.reshape(v.shape[0], H, -1).transpose(0, 1))
    return e.sum(2).t(), num.transpose(0, 1).reshape(q.shape[0], -1)


def _dot_operands(grid, H, d, seed):
    """q, k, v, a combined row max at or above the live max, cotangents."""
    g = torch.Generator().manual_seed(seed)
    rh, ch = grid.mask.shape
    q = torch.randn(rh, H * d, generator=g)
    k = torch.randn(ch, H * d, generator=g)
    v = torch.randn(ch, H * d, generator=g)
    scale = tgat._scale(d)
    m = _dense_dot_scores(grid.mask, q, k, H, scale).amax(2).t()
    rm = torch.where(torch.isfinite(m), m, torch.zeros(())) + torch.rand(
        rh, H, generator=g) * (torch.arange(rh) % 3 == 0)[:, None]
    gden = torch.randn(rh, H, generator=g)
    gnum = torch.randn(rh, H * d, generator=g)
    return q, k, v, rm, gden, gnum, scale


@pytest.mark.parametrize("H,d", DOT_CASES)
def test_dot_modes_match_the_dense_grid_and_its_autograd(H, d):
    """The four dot modes' plain versions, and the autograd Function over
    them, against the dense formula and its autograd on a grid with pad
    rows and columns that repeat slot 0, a row with no live entry (3) and
    a hub row (2)."""
    grid = _dot_grid(seed=30 + H)
    bits, bits_t, n_r, _ = hotattn.live_masks(
        grid.dense, grid.prs, grid.pcs, grid.cmp_r, grid.cmp_c, grid.own)
    assert n_r[3] == 0 and n_r[2] == grid.n_c > 4 * n_r.float().median()
    assert (grid.prs[grid.n_r:] == 0).all() and grid.cmp_r[0] >= 0
    q, k, v, rm, gden, gnum, scale = _dot_operands(grid, H, d, seed=d)
    want_m = _dense_dot_scores(grid.mask, q, k, H, scale).amax(2).t()
    got_m = hotattn.dot_rowmax_ref(bits, q, k, H, scale)
    assert torch.isinf(got_m[3]).all() and (got_m[3] < 0).all()
    torch.testing.assert_close(got_m, want_m, **DOT_TOL)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    den, num = _dense_dot_terms(grid.mask, *leaves, rm, H, scale)
    ((den * gden).sum() + (num * gnum).sum()).backward()
    got_den, got_num = hotattn.dot_terms_ref(bits, q, k, v, rm, H, scale)
    dq = hotattn.dot_bwd_row_ref(bits, q, k, v, rm, gden, gnum, H, scale)
    dk, dv = hotattn.dot_bwd_col_ref(bits_t, q, k, v, rm, gden, gnum, H,
                                     scale)
    fn = [t.clone().requires_grad_() for t in (q, k, v)]
    f_den, f_num = hotattn.dot_terms(bits, bits_t, *fn, rm, H, scale)
    ((f_den * gden).sum() + (f_num * gnum).sum()).backward()
    for name, a, b in (("den", got_den, den), ("num", got_num, num),
                       ("dq", dq, leaves[0].grad), ("dk", dk, leaves[1].grad),
                       ("dv", dv, leaves[2].grad),
                       ("fn den", f_den, den), ("fn num", f_num, num),
                       ("fn dq", fn[0].grad, leaves[0].grad),
                       ("fn dk", fn[1].grad, leaves[1].grad),
                       ("fn dv", fn[2].grad, leaves[2].grad)):
        torch.testing.assert_close(a.detach(), b.detach(), **DOT_TOL,
                                   msg=name)
    # the row without a live entry adds nothing
    assert (got_den[3] == 0).all() and (got_num[3] == 0).all()
    assert (dq[3] == 0).all()


# --- the model's hot-block attention ----------------------------------------

class Resident:
    """A small graph's resident state (bfloat16 block, as the cell's) and
    one batch of its layers, stream tiles on or off."""

    def __init__(self, stream: bool, seed: int = 0):
        orders = (1, 1, 1)
        g = make_powerlaw_graph(num_nodes=1500, avg_degree=10, num_feats=12,
                                num_classes=5, seed=seed)
        lap = build_laplacian(g.adj_full, "gatv1")
        spec = HotSpec.from_sample_prob(
            compute_sample_prob(lap, g.train_nodes, len(orders)), 512)
        d, dt = build_hot_dense(lap, spec, torch.bfloat16, "cpu")
        host = build_resident_graph(lap, spec, d, dt, val_dtype="bfloat16")
        self.g, self.lap, self.host = g, lap, host
        self.rg = ResidentGraph.from_host(host, "cpu")
        self.cfg = SamplerConfig(
            batch_size=64, samp_num=128, orders=orders,
            num_nodes=lap.shape[0], num_classes=5, adj_format="resident",
            hot_spec=spec, resident_val_free=host["val_free"],
            resident_stream_tiles=stream)

    def batch(self, seed=5):
        mb = ladies_sample(self.cfg, seed, self.g.train_nodes[:64], self.lap,
                           self.g.labels)
        batch = to_device_batch(mb, "cpu")
        return mb, batch, prepare_adjs(batch, self.rg)


@pytest.fixture(scope="module", params=[True, False],
                ids=["stream_tiles", "cold_coo"])
def resident(request):
    return Resident(request.param)


def _layer_operands(a, batch, layer, H, d, seed):
    g = torch.Generator().manual_seed(seed)
    el = torch.randn(a.nrows, H, generator=g)
    er = torch.randn(a.ncols, H, generator=g)
    v = torch.randn(a.ncols, H * d, generator=g)
    w = torch.randn(a.nrows, H * d, generator=g)
    sp = tgat._self_pos(batch.sampled_nodes[layer], a.nrows)
    return el, er, v, w, sp


def _run(fn, a, score_of, leaves, w):
    leaves = [t.clone().requires_grad_() for t in leaves]
    y = fn(a, score_of(*leaves[:-1]), leaves[-1])
    (y * w).sum().backward()
    return [y.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("H,d", [(2, 8), (3, 5)])
@pytest.mark.parametrize("layer", [0, 1])
def test_additive_hot_attention_matches_the_dense_route(resident, H, d,
                                                         layer):
    """The additive source on one part takes the live route (no grid)
    and gives the dense route's output and gradients of el, er and v."""
    _, batch, adjs = resident.batch(seed=8)
    a = adjs[layer]
    el, er, v, w, sp = _layer_operands(a, batch, layer, H, d, seed=layer)
    score = tgat.AdditiveScores(el, er, sp, SLOPE)
    grid = score.hot_part(a, a.rowpos.index_select(
        0, a.present_row_slots.long()), a.colpos.index_select(
        0, a.present_col_slots.long()), v)
    assert isinstance(grid, hotattn.LiveGrid)
    assert hotattn.unpack_bits(grid.bits, grid.erh.shape[0]).sum() > 50

    def score_of(el_, er_):
        return tgat.AdditiveScores(el_, er_, sp, SLOPE)
    want = _run(_hot_attention_parent, a, score_of, (el, er, v), w)
    got = _run(tgat.hot_attention, a, score_of, (el, er, v), w)
    for name, x, y in zip(("y", "d el", "d er", "dv"), got, want):
        torch.testing.assert_close(x, y, **MODE_TOL, msg=name)


@pytest.mark.parametrize("source", ["dot"])
def test_dense_routes_bit_equal_to_before(resident, source):
    """The dot-product source on a part's shard of the block (one part of
    one) keeps the dense grid, and on one part takes its live entries,
    whose CPU plain versions are the dense grid's operations: both
    bit-equal to before."""
    _, batch, adjs = resident.batch(seed=9)
    H, d = 2, 8
    for a, kind in ((adjs[1], hotattn.DotLiveGrid),
                    (dataclasses.replace(adjs[1], part_axis=PartGroup(0, 1)),
                     tgat.DenseGrid)):
        _, _, v, w, _ = _layer_operands(a, batch, 1, H, d, seed=3)
        g = torch.Generator().manual_seed(4)
        leaves = (torch.randn(a.nrows, H * d, generator=g),
                  torch.randn(a.ncols, H * d, generator=g), v)

        def score_of(q, k):
            return tgat.DotScores(q, k, H)
        assert isinstance(score_of(*leaves[:2]).hot_part(
            a, a.rowpos.index_select(0, a.present_row_slots.long()),
            a.colpos.index_select(0, a.present_col_slots.long()), v), kind)
        want = _run(_hot_attention_parent, a, score_of, leaves, w)
        got = _run(tgat.hot_attention, a, score_of, leaves, w)
        for name, x, y in zip(("y", "d0", "d1", "dv"), got, want):
            assert torch.equal(x, y), (kind.__name__, name)


@pytest.mark.parametrize("H,d", DOT_CASES)
@pytest.mark.parametrize("layer", [0, 1])
def test_dot_live_grid_matches_the_dense_grid(resident, H, d, layer):
    """gat's hot part on one part (the live grid) against the dense grid
    (a part of one) on a resident layer whose pads repeat a true present
    slot, with a row without a hot edge and a hub row: the row max,
    ``den``, ``num`` and the gradients of ``q``, ``k`` and ``v``."""
    _, batch, adjs = resident.batch(seed=8)
    a = adjs[layer]
    sentinel = 1 << 30
    n_r = int((a.row_cmp_idx != sentinel).sum())
    n_c = int((a.col_cmp_idx != sentinel).sum())
    prs, pcs = a.present_row_slots.clone(), a.present_col_slots.clone()
    assert prs.shape[0] > n_r and pcs.shape[0] > n_c
    # the pads repeat the first true slot, which the mask must leave out
    prs[n_r:], pcs[n_c:] = prs[0], pcs[0]
    dense = a.dense.clone()
    dense[prs[1].long()] = 0                              # no hot edge
    dense[prs[2].long(), pcs[:n_c].long()] = 1            # a hub row
    a = dataclasses.replace(a, dense=dense, present_row_slots=prs,
                            present_col_slots=pcs)
    g = torch.Generator().manual_seed(10 * H + layer)
    q = torch.randn(a.nrows, H * d, generator=g)
    k = torch.randn(a.ncols, H * d, generator=g)
    v = torch.randn(a.ncols, H * d, generator=g)
    rh, ch = prs.shape[0], pcs.shape[0]
    gden, gnum = torch.randn(H, rh, generator=g), torch.randn(H, rh, d,
                                                              generator=g)
    r_loc = a.rowpos.index_select(0, prs.long())
    c_loc = a.colpos.index_select(0, pcs.long())
    outs = []
    for part, kind in ((None, hotattn.DotLiveGrid),
                       (PartGroup(0, 1), tgat.DenseGrid)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        hot = tgat.DotScores(leaves[0], leaves[1], H).hot_part(
            dataclasses.replace(a, part_axis=part), r_loc, c_loc, leaves[2])
        assert isinstance(hot, kind)
        m = hot.rowmax(count_live=False)
        rm = torch.where(torch.isfinite(m), m, torch.zeros(())).t() + 0.5
        den, num = hot.terms(rm)
        ((den * gden).sum() + (num * gnum).sum()).backward()
        outs.append([m, den.detach(), num.detach()]
                    + [t.grad for t in leaves])
        if kind is hotattn.DotLiveGrid:
            n = hotattn.unpack_bits(hot.bits, ch).sum(1)
            assert n[1] == 0 and n[2] == n_c > 4 * n[:n_r].float().median()
            assert (n[n_r:] == 0).all()
    assert torch.isinf(outs[0][0][:, 1]).all()
    for name, x, y in zip(("m", "den", "num", "dq", "dk", "dv"), *outs):
        torch.testing.assert_close(x, y, **DOT_TOL, msg=name)


def test_gatv1_refuses_a_part_sharded_layer(resident):
    """A gatv1 layer on a part's shard of the block (here one part of
    one) raises, naming the queue item: its hot part runs on one part
    only."""
    _, batch, adjs = resident.batch(seed=9)
    a = dataclasses.replace(adjs[0], part_axis=PartGroup(0, 1))
    conv = tgat.GATv1Conv(12, 4, 2)
    x = torch.zeros(a.ncols, 12)
    with pytest.raises(NotImplementedError, match="ROADMAP.md: gatv1-parts"):
        conv(x, a, batch.sampled_nodes[0])


# --- the counters ----------------------------------------------------------------

def test_count_attention_adds_no_dense_entries_where_the_hot_part_runs_live(
        resident):
    from gnn_tpu_torch.models.gnn import build_model
    mb, batch, adjs = resident.batch()
    # the layers' score sources decide: on one part both gat's dot product
    # and gatv1's additive source walk the live entries; gat on a part's
    # shard of the block keeps the grid
    gat = build_model("gat", 16, (1, 1, 1), 5, 12)
    gatv1 = build_model("gatv1", 16, (1, 1, 1), 5, 12)
    assert tgat.AttentionCounts.of(build_model("graphsage", 16, (1, 1, 1),
                                               5, 12)) is None
    # epoch keys of this case alone
    live, dot, dense, flush, fwd = (
        f"hotattn-{w}-{id(resident)}"
        for w in ("live", "dot", "dense", "flush", "fwd"))
    prev = RECORDER.epoch
    try:
        for key, net, sharded in ((live, gatv1, False), (dot, gat, False),
                                  (dense, gat, True)):
            RECORDER.epoch = key
            tgat.AttentionCounts.of(net, sharded).staged(mb)
        # gat's training forward counts its live entries on the device
        RECORDER.epoch = flush
        hotattn.live_counter("cpu")
        hotattn.record_live_entries()
        RECORDER.epoch = fwd
        x = torch.from_numpy(resident.g.feats)[batch.input_nodes.long()]
        gat(x, adjs, batch.sampled_nodes)
        hotattn.record_live_entries()
    finally:
        RECORDER.epoch = prev
    heads = tgat.attention_heads(gat)
    assert heads == [1, 1, 1]
    want = sum(h * a.rh_pad * a.ch_pad for h, a in zip(heads, mb.adjs))
    assert want > 0
    # the counter is there, at 0, so the metric reads 0.0, not nothing
    assert RECORDER.total("attn.dense_entries", [live], "count") == 0
    assert RECORDER.total("attn.dense_entries", [dot], "count") == 0
    assert RECORDER.total("attn.dense_entries", [dense], "count") == want
    slots = [RECORDER.total("attn.cold_slots", [key], "count")
             for key in (live, dot, dense)]
    assert slots[0] == slots[1] == slots[2] > 0
    n_live = 0
    for h, a in zip(heads, adjs):
        r_loc = a.rowpos.index_select(0, a.present_row_slots.long())
        bits = hotattn._live_set(a, r_loc)[0]
        n_live += h * int(hotattn.unpack_bits(
            bits, a.present_col_slots.shape[0]).sum())
    assert n_live > 0
    assert RECORDER.total("attn.hot_live_entries", [fwd], "count") == n_live


def test_live_entries_count_in_training_forwards_only(resident):
    _, batch, adjs = resident.batch(seed=11)
    a = adjs[0]
    H, d = 3, 4
    el, er, v, _, sp = _layer_operands(a, batch, 0, H, d, seed=6)
    score = tgat.AdditiveScores(el, er, sp, SLOPE)
    grid = score.hot_part(a, a.rowpos.index_select(
        0, a.present_row_slots.long()), a.colpos.index_select(
        0, a.present_col_slots.long()), v)
    n_live = int(hotattn.unpack_bits(grid.bits, grid.erh.shape[0]).sum())
    assert n_live > 0
    flush, counted, none = (f"hotattn-{w}-{id(resident)}"
                            for w in ("flush", "count", "none"))
    prev = RECORDER.epoch
    try:
        RECORDER.epoch = flush
        hotattn.live_counter("cpu")
        hotattn.record_live_entries()
        RECORDER.epoch = counted
        with torch.no_grad():
            tgat.hot_attention(a, score, v)
        tgat.hot_attention(a, score, v)
        hotattn.record_live_entries()
        RECORDER.epoch = none
        hotattn.record_live_entries()
    finally:
        RECORDER.epoch = prev
    assert RECORDER.total("attn.hot_live_entries", [counted],
                          "count") == H * n_live
    assert RECORDER.total("attn.hot_live_entries", [none], "count") == 0


def test_an_epoch_records_its_live_entries():
    """An eager CPU epoch of gatv1 records ``attn.hot_live_entries`` (each
    step's layers' live entries times their heads) and no dense
    entries."""
    from gnn_tpu_torch.sampling.pipeline import BatchPipeline
    from gnn_tpu_torch.train.trainer import Trainer
    r = Resident(True)
    net = tgat.GATv1(12, 16, (1, 1, 1), 5, hidden_heads=2, output_heads=3)
    tr = Trainer(net, BatchPipeline(r.cfg, r.lap, r.g.labels, pool_num=1,
                                    seed=3),
                 r.g.feats, lr=0.005, sigmoid_loss=True, seed=3,
                 resident_graph=r.host, device="cpu")
    epoch = 9_101
    prev = RECORDER.epoch
    try:
        hotattn.record_live_entries()
        m = tr.train_epoch(r.g.train_nodes[:64 * 2], epoch=epoch)
    finally:
        tr.pipeline.close()
        RECORDER.epoch = prev
    assert len(m.step_losses) == 2
    n = RECORDER.total("attn.hot_live_entries", [epoch], "count")
    assert n is not None and n > 0
    assert RECORDER.total("attn.dense_entries", [epoch], "count") == 0


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    return torch.device("cuda")


def _big_grid(seed, rh, ch, density, n_slots=None):
    """A layer-0-like present grid on a bfloat16 0/1 block of ``k``
    slots: every present row and column true but the last 64 pad rows /
    32 pad columns (repeats of the first slot), each row owning a random
    column (some past ``ch``: none)."""
    g = torch.Generator().manual_seed(seed)
    # rows of 16 B multiples (the mask pass's vector loads)
    k = n_slots or -(-(max(rh, ch) + 256) // 8) * 8
    dense = (torch.rand(k, k, generator=g) < density).to(torch.bfloat16)
    n_r, n_c = rh - 64, ch - 32
    slots_r = torch.randperm(k, generator=g)[:n_r]
    slots_c = torch.randperm(k, generator=g)[:n_c]
    prs = torch.cat([slots_r, slots_r[:1].repeat(rh - n_r)]).int()
    pcs = torch.cat([slots_c, slots_c[:1].repeat(ch - n_c)]).int()
    cmp_r = torch.full((k,), -1, dtype=torch.int32)
    cmp_r[slots_r] = torch.arange(n_r, dtype=torch.int32)
    cmp_c = torch.full((k,), -1, dtype=torch.int32)
    cmp_c[slots_c] = torch.arange(n_c, dtype=torch.int32)
    own = torch.randint(0, ch + 40, (rh,), generator=g).int()
    return dense, prs, pcs, cmp_r, cmp_c, own


# (H, d, rh, ch, density): the hidden layers' 4 x 256 on a reduced
# layer-0 grid at the cell's 3% density, the output layer's 6 x 41, and
# odd sizes (rh, ch not multiples of 32)
CARD_CASES = [(4, 256, 1600, 1700, 0.03), (6, 41, 900, 1300, 0.03),
              (4, 41, 333, 517, 0.2), (1, 8, 70, 45, 0.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,d,rh,ch,density", CARD_CASES)
def test_cuda_kernels_match_the_plain_versions(cuda_device, H, d, rh, ch,
                                               density):
    dev = cuda_device
    host = _big_grid(H + d, rh, ch, density)
    bits_ref, bits_t_ref, n_r_ref, n_c_ref = hotattn.live_masks_ref(*host)
    ops = [t.to(dev) for t in host]
    before = dict(hotattn.launches)
    bits, bits_t, n_r, n_c = hotattn.live_masks(*ops)
    torch.cuda.synchronize()
    assert torch.equal(bits.cpu(), bits_ref)
    assert torch.equal(bits_t.cpu(), bits_t_ref)
    assert torch.equal(n_r.cpu(), n_r_ref) and torch.equal(n_c.cpu(), n_c_ref)
    # the blocks take the rows and columns heaviest first: any order gives
    # the same bits
    orders = tuple(torch.argsort(n, descending=True, stable=True).int()
                   for n in (n_r, n_c))
    g = torch.Generator().manual_seed(d)
    el, er = torch.randn(rh, H, generator=g), torch.randn(ch, H, generator=g)
    v = torch.randn(ch, H * d, generator=g)
    gden, gnum = torch.randn(rh, H, generator=g), torch.randn(
        rh, H * d, generator=g)
    m_ref = hotattn.rowmax_ref(bits_ref, el, er, SLOPE)
    rm = torch.where(torch.isfinite(m_ref), m_ref, torch.zeros(()))
    cuda = [t.to(dev) for t in (el, er, v, rm, gden, gnum)]
    ctr = hotattn.live_counter(dev)
    n0 = int(ctr.item())
    m = hotattn.rowmax(bits, *cuda[:2], SLOPE, count_live=True,
                       order=orders[0])
    n_live = int(hotattn.unpack_bits(bits_ref, ch).sum())
    assert int(ctr.item()) - n0 == H * n_live
    # the row max is exact: one add and one multiply a score
    torch.testing.assert_close(m.cpu(), m_ref, rtol=0, atol=0)
    leaves = [t.clone().requires_grad_() for t in cuda[:3]]
    den, num = hotattn.terms(bits, bits_t, *leaves, cuda[3], SLOPE, orders)
    ((den * cuda[4]).sum() + (num * cuda[5]).sum()).backward()
    want = hotattn.terms_ref(bits_ref, el, er, v, rm, SLOPE)
    d_el = hotattn.bwd_row_ref(bits_ref, el, er, v, rm, gden, gnum, SLOPE)
    d_er, dv = hotattn.bwd_col_ref(bits_t_ref, el, er, v, rm, gden, gnum,
                                   SLOPE)
    # each entry's magnitude: the sum of its terms' absolute values, the
    # plain versions on |v|, |g den|, |g num| (every term then >= 0)
    mags = (*hotattn.terms_ref(bits_ref, el, er, v.abs(), rm, SLOPE),
            hotattn.bwd_row_ref(bits_ref, el, er, v.abs(), rm, gden.abs(),
                                gnum.abs(), SLOPE),
            *hotattn.bwd_col_ref(bits_t_ref, el, er, v.abs(), rm,
                                 gden.abs(), gnum.abs(), SLOPE))
    torch.cuda.synchronize()
    # float32 sums in another order (the kernels' sequential sums and
    # lane splits against dense reductions and matmuls). A gradient's
    # terms cancel (one d el entry of 1.3e-3 sums terms of 1,252 in all),
    # so each entry is held to 1e-5 of its own magnitude, some 80 ulps
    # of it (the plain float32 versions sit within 3e-7 of it from
    # float64); an entry with no live term must be exactly 0
    for name, a, b, mag in zip(("den", "num", "d el", "d er", "dv"),
                               (den, num, *(t.grad for t in leaves)),
                               (*want, d_el, d_er, dv), mags):
        err = (a.detach().cpu() - b).abs()
        bad = ~(err <= 1e-5 * mag)
        assert not bad.any(), (name, int(bad.sum()), float(err[bad].max()),
                               float(mag[bad].max()))
    for key in ("mask", "rowmax", "terms", "bwd_row", "bwd_col"):
        assert hotattn.launches[key] == before.get(key, 0) + 1, key
    # the same words and entries again, in the rows' own order, give the
    # same bits
    den2, num2 = hotattn.terms(bits, bits_t, *cuda[:4], SLOPE)
    assert torch.equal(den2, den.detach()) and torch.equal(num2,
                                                           num.detach())
    d_el2 = hotattn.bwd_row(bits, *cuda, SLOPE)
    d_er2, dv2 = hotattn.bwd_col(bits_t, *cuda, SLOPE)
    assert torch.equal(d_el2, leaves[0].grad)
    assert torch.equal(d_er2, leaves[1].grad)
    assert torch.equal(dv2, leaves[2].grad)


# (H, d, rh, ch, density): gat's one head of 512 on a reduced layer-0 grid
# at the cell's 3% density with hub rows and columns, two heads of 6 (the
# scalar path), and odd sizes
DOT_CARD_CASES = [(1, 512, 1600, 1700, 0.03), (2, 6, 900, 1300, 0.03),
                  (1, 40, 333, 517, 0.2)]


def _dot_mags(bits, q, k, v, rm, gden, gnum, H, scale):
    """Each dot output's magnitude, the sum of its terms' absolute values
    over the dense grid: ``(m, den, num, dq, dk, dv)``."""
    def heads(t):
        return t.reshape(t.shape[0], H, -1).transpose(0, 1)

    def flat(t):
        return t.transpose(0, 1).reshape(t.shape[1], -1)
    live = hotattn.unpack_bits(bits, k.shape[0])[None]
    zero = torch.zeros(())
    mag_s = torch.where(live, torch.matmul(heads(q.abs()), heads(
        k.abs()).transpose(1, 2)) * scale, zero)
    s = torch.where(live, torch.matmul(heads(q), heads(k).transpose(1, 2))
                    * scale, torch.full((), float("-inf")))
    e = torch.exp(s - rm.t()[:, :, None])
    t = gden.abs().t()[:, :, None] + torch.matmul(
        heads(gnum.abs()), heads(v.abs()).transpose(1, 2))
    ds = e * t
    return (mag_s.amax(2).t(), e.sum(2).t(),
            flat(torch.matmul(e, heads(v.abs()))),
            flat(torch.matmul(ds, heads(k.abs()))) * scale,
            flat(torch.matmul(ds.transpose(1, 2), heads(q.abs()))) * scale,
            flat(torch.matmul(e.transpose(1, 2), heads(gnum.abs()))))


@pytest.mark.cuda
@pytest.mark.parametrize("H,d,rh,ch,density", DOT_CARD_CASES)
def test_cuda_dot_kernels_match_the_plain_versions(cuda_device, H, d, rh, ch,
                                                   density):
    """The dot modes against their plain versions on a skewed grid (16
    hub rows and 16 hub columns at half density), each launched once a
    call; any block order gives the same bits."""
    dev = cuda_device
    dense, prs, pcs, cmp_r, cmp_c, _ = _big_grid(H + d, rh, ch, density)
    g = torch.Generator().manual_seed(d)
    dense[prs[:16].long()] = (torch.rand(16, dense.shape[1], generator=g)
                              < 0.5).to(dense.dtype)
    dense[:, pcs[:16].long()] = (torch.rand(dense.shape[0], 16, generator=g)
                                 < 0.5).to(dense.dtype)
    own = torch.full((rh,), -1, dtype=torch.int32)
    host = (dense, prs, pcs, cmp_r, cmp_c, own)
    bits_ref, bits_t_ref, n_r_ref, _ = hotattn.live_masks_ref(*host)
    assert n_r_ref.max() > 2 * n_r_ref.float().median()
    before = dict(hotattn.launches)
    bits, bits_t, n_r, n_c = hotattn.live_masks(*(t.to(dev) for t in host))
    assert torch.equal(bits.cpu(), bits_ref)
    assert torch.equal(bits_t.cpu(), bits_t_ref)
    orders = tuple(torch.argsort(n, descending=True, stable=True).int()
                   for n in (n_r, n_c))
    scale = tgat._scale(d)
    q, k, v = (torch.randn(n, H * d, generator=g) for n in (rh, ch, ch))
    m_ref = hotattn.dot_rowmax_ref(bits_ref, q, k, H, scale)
    rm = torch.where(torch.isfinite(m_ref), m_ref, torch.zeros(()))
    gden, gnum = torch.randn(rh, H, generator=g), torch.randn(
        rh, H * d, generator=g)
    cuda = [t.to(dev) for t in (q, k, v, rm, gden, gnum)]
    ctr = hotattn.live_counter(dev)
    n0 = int(ctr.item())
    m = hotattn.dot_rowmax(bits, *cuda[:2], H, scale, count_live=True,
                           order=orders[0])
    assert int(ctr.item()) - n0 == H * int(n_r_ref.sum())
    leaves = [t.clone().requires_grad_() for t in cuda[:3]]
    den, num = hotattn.dot_terms(bits, bits_t, *leaves, cuda[3], H, scale,
                                 orders)
    ((den * cuda[4]).sum() + (num * cuda[5]).sum()).backward()
    want = (m_ref, *hotattn.dot_terms_ref(bits_ref, q, k, v, rm, H, scale),
            hotattn.dot_bwd_row_ref(bits_ref, q, k, v, rm, gden, gnum, H,
                                    scale),
            *hotattn.dot_bwd_col_ref(bits_t_ref, q, k, v, rm, gden, gnum, H,
                                     scale))
    mags = _dot_mags(bits_ref, q, k, v, rm, gden, gnum, H, scale)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(m.cpu()), torch.isinf(m_ref))
    # float32 sums in another order (a lane's slice, then the head's
    # lanes, then the warps in order) against dense matmuls: each entry
    # within 1e-5 of its magnitude, some 80 ulps of it; an entry with no
    # live term exactly 0
    for name, a, b, mag in zip(("m", "den", "num", "dq", "dk", "dv"),
                               (m, den, num, *(t.grad for t in leaves)),
                               want, mags):
        a, fin = a.detach().cpu(), torch.isfinite(b)
        err = (a[fin] - b[fin]).abs()
        bad = ~(err <= 1e-5 * mag[fin])
        assert not bad.any(), (name, int(bad.sum()), float(err[bad].max()))
    for key in ("mask", "dot_rowmax", "dot_terms", "dot_bwd_row",
                "dot_bwd_col"):
        assert hotattn.launches[key] == before.get(key, 0) + 1, key
    for key in ("rowmax", "terms", "bwd_row", "bwd_col"):
        assert hotattn.launches[key] == before.get(key, 0), key
    # in the rows' own order: the same bits
    den2, num2 = hotattn.dot_terms(bits, bits_t, *cuda[:4], H, scale)
    assert torch.equal(den2, den.detach()) and torch.equal(num2,
                                                           num.detach())
    assert torch.equal(hotattn.dot_bwd_row(bits, *cuda, H, scale),
                       leaves[0].grad)
    dk2, dv2 = hotattn.dot_bwd_col(bits_t, *cuda, H, scale)
    assert torch.equal(dk2, leaves[1].grad) and torch.equal(dv2,
                                                            leaves[2].grad)


def _trace_kernels(fn):
    """Calls of each CUDA kernel ``fn()`` launches, by name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.name] = names.get(e.name, 0) + 1
    return names


@pytest.mark.cuda
def test_cuda_hot_kernels_have_names_of_their_own(cuda_device):
    """A gatv1 training step on the card: the hot kernels appear under
    names of their own (none holds ``edge_attention``), the additive
    K3/K4 keep their four calls a layer (``edge_attention_additive_kernel``),
    and the dot product's ``edge_attention_kernel`` none."""
    from gnn_tpu_torch.train.loss import masked_loss
    r = Resident(True)
    mb, _, _ = r.batch()
    dev = cuda_device
    rg = ResidentGraph.from_host(r.host, dev)
    batch = to_device_batch(mb, dev)
    adjs = prepare_adjs(batch, rg)
    net = tgat.GATv1(12, 16, (1, 1, 1), 5, hidden_heads=2,
                     output_heads=3).to(dev)
    x = torch.from_numpy(r.g.feats).to(dev)[batch.input_nodes.long()]

    def step():
        out = net(x, adjs, batch.sampled_nodes)
        masked_loss(out, batch.labels, batch.label_mask, True).backward()
    step()
    names = _trace_kernels(step)
    n_layers = 3

    def calls(part):
        return sum(n for name, n in names.items() if part in name)
    assert calls("edge_attention_additive_kernel") == 4 * n_layers, names
    assert calls("edge_attention_kernel") == 0, names
    assert calls("hot_additive_kernel") == 4 * n_layers, names
    assert calls("hot_mask_kernel") == n_layers, names
    assert calls("hot_mask_transpose_kernel") == n_layers, names
    assert not any("edge_attention" in name for name in names
                   if "hot_" in name), names


@pytest.mark.cuda
def test_cuda_gat_hot_part_launches_only_the_dot_modes(cuda_device):
    """A gat training step on the card: the hot part launches the mask
    pass and the four dot modes a layer under their own names
    (``hot_dot_kernel``), no additive hot kernel, and no ``[H, rh, ch]``
    product; K3/K4 keep their four calls a layer."""
    from gnn_tpu_torch.models.gnn import build_model
    from gnn_tpu_torch.train.loss import masked_loss
    r = Resident(True)
    mb, _, _ = r.batch()
    dev = cuda_device
    rg = ResidentGraph.from_host(r.host, dev)
    batch = to_device_batch(mb, dev)
    adjs = prepare_adjs(batch, rg)
    net = build_model("gat", 16, (1, 1, 1), 5, 12).to(dev)
    x = torch.from_numpy(r.g.feats).to(dev)[batch.input_nodes.long()]
    grids = {(1, a.present_row_slots.shape[0], a.present_col_slots.shape[0])
             for a in adjs}
    shapes = []

    class Count(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor):
                shapes.append(tuple(out.shape))
            return out

    def step():
        out = net(x, adjs, batch.sampled_nodes)
        masked_loss(out, batch.labels, batch.label_mask, True).backward()
    step()
    before = dict(hotattn.launches)
    with Count():
        names = _trace_kernels(step)
    n_layers = 3
    assert not grids & set(shapes), grids

    def calls(part):
        return sum(n for name, n in names.items() if part in name)
    assert calls("hot_dot_kernel") == 4 * n_layers, names
    assert calls("hot_additive_kernel") == 0, names
    assert calls("hot_mask_kernel") == n_layers, names
    assert calls("hot_mask_transpose_kernel") == n_layers, names
    assert calls("edge_attention_kernel") == 4 * n_layers, names
    for key in ("mask", "dot_rowmax", "dot_terms", "dot_bwd_row",
                "dot_bwd_col"):
        assert hotattn.launches[key] == before.get(key, 0) + n_layers, key


# --- the dense route as it was ---------------------------------------------

def _dense_operands(score, r_loc, c_loc):
    """The dense route's hot operands of a score source and their ``[H,
    rh, ch]`` scores: the dot product of the rows' ``q`` and the columns'
    ``k`` split by head, or the outer sum of the rows' ``el`` and the
    columns' ``er`` through LeakyReLU."""
    if isinstance(score, tgat.AdditiveScores):
        return ((tgat._take_rows_fill(score.el, r_loc).t(),
                 tgat._take_rows_fill(score.er, c_loc).t()),
                lambda elh, erh: F.leaky_relu(
                    elh[:, :, None] + erh[:, None, :], score.slope))

    def split(a):
        return a.reshape(a.shape[0], score.H, -1).transpose(0, 1)
    return ((split(tgat._take_rows_fill(score.q_pad, r_loc)),
             split(tgat._take_rows_fill(score.k, c_loc))),
            lambda qh, kh: torch.matmul(qh, kh.transpose(1, 2))
            * score.scale)


def _hot_attention_parent(adj, score, v):
    """`gnn_tpu_torch.models.gat.hot_attention` as it was before the
    additive score's hot part took its live entries alone (every source
    on the dense grid), frozen for the comparisons below."""
    part = adj.part_axis
    H = score.H
    n_out = v.shape[1]
    d = n_out // H
    dev = v.device
    use_es = adj.es_rc is not None
    cold_empty = (not use_es) and adj.rows.shape[0] == 0
    if use_es and adj.cold_partial:
        raise ValueError("stream tiles are replicated across parts (lite "
                         "mode); a partial cold residual comes as a COO")

    # --- hot part: compacted [rh, ch] dense scores ---
    sentinel = 1 << 30
    rh = adj.present_row_slots.shape[0]
    ch = adj.present_col_slots.shape[0]
    r_loc = adj.rowpos.index_select(0, adj.present_row_slots.long())
    c_loc = adj.colpos.index_select(0, adj.present_col_slots.long())
    # the present arrays pad by repeating slot 0: mask the pad entries by
    # the true present counts, or columns would aggregate twice
    n_hot_r = (adj.row_cmp_idx != sentinel).sum()
    n_hot_c = (adj.col_cmp_idx != sentinel).sum()
    row_ok = torch.arange(rh, device=dev) < n_hot_r
    col_ok = torch.arange(ch, device=dev) < n_hot_c
    d_rows = adj.dense.index_select(0, adj.present_row_slots.long())
    if part is not None:
        # this part's slot columns only
        ksh = adj.dense.shape[1]
        pcs_loc = adj.present_col_slots.long() - part.rank * ksh
        col_ok = col_ok & (pcs_loc >= 0) & (pcs_loc < ksh)
        d_sub = d_rows.index_select(1, pcs_loc.clamp(0, ksh - 1))
    else:
        d_sub = d_rows.index_select(1, adj.present_col_slots.long())
    mask_hot = (d_sub != 0) & row_ok[:, None] & col_ok[None, :]
    if score.self_pos is not None:
        # a hot row's self edge is its own term: off the hot mask
        own = tgat._take_rows_fill(score.self_pos[:, None], r_loc,
                                   fill=-1)[:, 0]
        own_cmp = tgat._take_rows_fill(adj.col_cmp_idx[:, None], own,
                                  fill=-1)[:, 0]
        mask_hot = mask_hot & (torch.arange(ch, device=dev)[None, :]
                               != own_cmp[:, None])

    hot_ops, hot = _dense_operands(score, r_loc, c_loc)
    vh = tgat._take_rows_fill(v, c_loc).reshape(ch, H, d).transpose(0, 1)

    def hot_scores(*ops):
        return torch.where(mask_hot[None], hot(*ops),
                           torch.full((), tgat._NEG_INF, device=dev))

    if part is not None:
        # the row max crosses the parts: a score pass without gradient,
        # its max taken over the part group; the differentiable scores
        # are recomputed inside the terms below
        with torch.no_grad():
            m_hot = hot_scores(*hot_ops).amax(dim=2).contiguous()
        tgat.part_max_(m_hot, part)
    else:
        # ONE differentiable score pass serves the row max (detached:
        # the max is a softmax shift whose gradient cancels) and the terms
        s_hot = hot_scores(*hot_ops)
        m_hot = s_hot.detach().amax(dim=2)                    # [H, rh]

    # --- cold residual, pass 1: per-row score max ---
    if use_es:
        cold_ops = score.cold_operands()
        walk = dict(n_heads=H, bm=adj.es_bm, bk=adj.es_bk, slope=score.slope)
        m_cold = tgat.esattn.cold_rowmax(
            adj.es_coords, adj.es_rc, adj.es_off,
            tuple(o.detach() for o in cold_ops), **walk)
        # the kernel writes float32 min for rows without a cold edge;
        # restore the -inf the combine below expects
        m_cold = torch.where(m_cold > tgat.esattn.NEG_SENTINEL / 2, m_cold,
                             torch.full((), tgat._NEG_INF, device=dev))
    elif cold_empty:
        m_cold = torch.full((adj.nrows, H), tgat._NEG_INF, device=dev)
    else:
        rows_c, cols_c = adj.rows.long(), adj.cols.long()
        live = adj.vals.float() != 0   # pads ship exactly 0
        if score.self_pos is not None:
            live = live & (score.self_pos.long().index_select(0, rows_c)
                           != cols_c)
        # a partial COO's terms recompute their scores inside the Function
        # below, so its score pass here serves the max alone
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not adj.cold_partial):
            s_cold = score.edge(rows_c, cols_c, live,
                                *score.edge_operands())
        m_cold = tgat._segment_max(s_cold.detach(), rows_c, adj.nrows)
        if adj.cold_partial:
            tgat.part_max_(m_cold, part)

    # --- one softmax across both parts (and the self edges) ---
    m_hot_rows = tgat._take_rows_fill(m_hot.t(), adj.row_cmp_idx,
                                 fill=tgat._NEG_INF)               # [nrows, H]
    row_max = torch.maximum(m_cold, m_hot_rows)
    if score.self_pos is not None:
        s_self = score.self_scores()                          # [nrows, H]
        row_max = torch.maximum(row_max, s_self.detach())
    row_max = torch.where(torch.isfinite(row_max), row_max,
                          torch.zeros((), device=dev)).detach()
    rm_cmp = tgat._take_rows_fill(row_max, r_loc)                  # [rh, H]

    def hot_terms(s, vh_):
        # s is -inf wherever masked BEFORE the exp: a masked entry's raw
        # s - rm could overflow, and its exp gradient would be 0 * inf
        e = torch.exp(s - rm_cmp.t()[:, :, None])
        return e.sum(dim=2), torch.matmul(e, vh_)   # [H, rh], [H, rh, d]

    if part is not None:
        den_hot, num_hot = tgat._PartSumTerms.apply(
            part, lambda *a: hot_terms(hot_scores(*a[:-1]), a[-1]),
            *hot_ops, vh)
    else:
        den_hot, num_hot = hot_terms(s_hot, vh)

    # --- cold pass 2: softmax denominators + aggregation ---
    if use_es:
        den_cold, num_cold = tgat.esattn.cold_terms(
            adj.es_coords, adj.es_rc, adj.es_off, adj.es_ord, cold_ops, v,
            row_max, **walk)
    elif cold_empty:
        den_cold = torch.zeros((adj.nrows, H), device=dev)
        num_cold = torch.zeros((adj.nrows, n_out), device=dev)
    else:
        def cold_terms(s_c, v_):
            att = (torch.exp(s_c - tgat._take_rows_fill(row_max, rows_c))
                   * live[:, None])                           # [nnz, H]
            return (att.new_zeros((adj.nrows, H)).index_add(0, rows_c, att),
                    tgat._edge_aggregate(att, rows_c, cols_c, v_, adj.nrows,
                                         H))

        if adj.cold_partial:
            den_cold, num_cold = tgat._PartSumTerms.apply(
                part, lambda *a: cold_terms(score.edge(
                    rows_c, cols_c, live, *a[:-1]), a[-1]),
                *score.edge_operands(), v)
        else:
            den_cold, num_cold = cold_terms(s_cold, v)
    num_cold = num_cold.to(v.dtype)

    den = tgat._take_rows_fill(den_hot.t(), adj.row_cmp_idx) + den_cold
    num = num_cold + tgat._take_rows_fill(
        num_hot.transpose(0, 1).reshape(rh, n_out),
        adj.row_cmp_idx).to(v.dtype)                          # [nrows, n_out]
    if score.self_pos is not None:
        e_self = torch.exp(s_self - row_max)                  # [nrows, H]
        v_self = v.index_select(0, score.self_pos.long())
        den = den + e_self
        num = num + (e_self[:, :, None] * v_self.reshape(
            adj.nrows, H, d)).reshape(adj.nrows, n_out)
    # den == 0 exactly iff the row has no edge (pad rows): substitute 1,
    # not a tiny epsilon, whose squared reciprocal in the division's
    # gradient overflows to inf and makes 0 * inf = NaN cotangents
    den_e = torch.where(den > 0, den, torch.ones((), device=dev))
    return (num.reshape(adj.nrows, H, d) / den_e[:, :, None]).reshape(
        adj.nrows, n_out)
