"""The edge-stream attention of the PyTorch port (gnn_tpu_torch.ops.esattn)
against the JAX package's (gnn_tpu.ops.pallas_esattn).

* The plain PyTorch versions of K3 (row max) and K4 (softmax terms) must
  match the Pallas kernels run in interpret mode on the same packed tiles
  and inputs, and the port's ``autograd.Function`` must give the
  gradients ``jax.grad`` gives through the Pallas custom VJP. Tolerances
  as the JAX package's own kernel tests: rtol = atol = 1e-5 for the row
  max, 2e-4 for the terms, 3e-4 for the gradients (float32 sums of
  exponentials in another order).
* A coordinate repeated within one entry counts once, as the Pallas
  kernel's ``A01 > 0`` mask counts it (the CUDA kernel drops repeats with
  a hash set of (entry, coordinate)); the resident packers never emit a
  repeated pair.
* ``CORE_CASES`` exercise the CUDA kernel's walk (a hub row, a row tile
  over one pass, a tile split over a cluster, several and odd heads, an
  empty tile, a width over 512); their plain versions are held against
  the Pallas kernel here.
* On a machine with a card, the CUDA kernels must match the plain
  versions, each entry point with one kernel launch (``-m cuda``; this
  module imports JAX only inside the parity helpers, so ``pytest
  --noconftest -m cuda`` runs it where JAX is absent).
"""
import numpy as np
import pytest
import torch

from gnn_tpu_torch.ops import esattn as tea
from gnn_tpu_torch.ops import edgestream as tes

RM_TOL = dict(rtol=1e-5, atol=1e-5)
TERMS_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=3e-4, atol=3e-4)

# nr, nc, n_out, H, nnz, bm, bk (tests/test_esattn.py's cases)
CASES = [
    (128, 256, 64, 1, 400, 128, 128),
    (256, 384, 64, 4, 900, 128, 128),
    (256, 256, 96, 8, 600, 256, 256),   # d = 12, 8 heads
    (384, 128, 32, 2, 2000, 128, 128),  # dense tiles -> entry splits
]


def _rand_edges(rng, nr, nc, nnz, dup=False):
    rows = rng.randint(0, nr, nnz).astype(np.int64)
    cols = rng.randint(0, nc, nnz).astype(np.int64)
    if not dup:
        _, ui = np.unique(rows * nc + cols, return_index=True)
        rows, cols = rows[ui], cols[ui]
    return rows, cols


def _inputs(seed, nr, nc, n_out, H, scale=1.0):
    rng = np.random.RandomState(seed)
    q = (scale * rng.randn(nr, n_out)).astype(np.float32)
    k = (scale * rng.randn(nc, n_out)).astype(np.float32)
    v = rng.randn(nc, n_out).astype(np.float32)
    return rng, q, k, v


def _t(tiles, device="cpu"):
    """``(coords, blk_rc, off, t_order)`` as tensors."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (tiles.coords, tiles.blk_rc, tiles.off,
                           tiles.t_order))


def _pallas_rowmax(tiles, q, k, H):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from gnn_tpu.ops import pallas_esattn as esat
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(esat.cold_attention_rowmax(
            jnp.asarray(tiles.coords), jnp.asarray(tiles.blk_rc),
            jnp.asarray(tiles.off), jnp.asarray(q), jnp.asarray(k),
            n_heads=H, bm=tiles.bm, bk=tiles.bk, interpret=True))


def _pallas_terms_and_grads(tiles, q, k, v, rm, H, wd, wn):
    """``(den, num, dq, dk, dv)`` of the Pallas terms kernel, the
    gradients of ``sum(den * wd) + sum(num * wn)``."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from gnn_tpu.ops import pallas_esattn as esat
    c, rc, off, order = (jnp.asarray(a) for a in (
        tiles.coords, tiles.blk_rc, tiles.off, tiles.t_order))

    def loss(q_, k_, v_):
        den, num = esat.cold_attention_terms(
            c, rc, off, order, q_, k_, v_, jnp.asarray(rm), n_heads=H,
            bm=tiles.bm, bk=tiles.bk, interpret=True)
        return jnp.sum(den * wd) + jnp.sum(num * wn), (den, num)

    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    with pltpu.force_tpu_interpret_mode():
        (_, terms), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(*args)
    return tuple(np.asarray(a) for a in tuple(terms) + tuple(grads))


def _port_terms_and_grads(tiles, q, k, v, rm, H, wd, wn, device="cpu"):
    qt, kt, vt = (torch.from_numpy(a).to(device).requires_grad_()
                  for a in (q, k, v))
    den, num = tea.cold_attention_terms(
        *_t(tiles, device), qt, kt, vt, torch.from_numpy(rm).to(device),
        n_heads=H, bm=tiles.bm, bk=tiles.bk)
    loss = ((den * torch.from_numpy(wd).to(device)).sum()
            + (num * torch.from_numpy(wn).to(device)).sum())
    loss.backward()
    return tuple(a.detach().cpu().numpy()
                 for a in (den, num, qt.grad, kt.grad, vt.grad))


def _finite_rowmax(rm):
    """The caller contract: row_max finite everywhere (rows without an
    edge read 0)."""
    return np.where(rm > tea.NEG_SENTINEL / 2, rm, 0.0).astype(np.float32)


def _check_against_pallas(tiles, q, k, v, H, seed):
    rm_p = _pallas_rowmax(tiles, q, k, H)
    rm_t = tea.cold_attention_rowmax(
        *_t(tiles)[:3], torch.from_numpy(q), torch.from_numpy(k),
        n_heads=H, bm=tiles.bm, bk=tiles.bk).numpy()
    np.testing.assert_allclose(rm_t, rm_p, **RM_TOL)
    rm = _finite_rowmax(rm_p)
    rng = np.random.RandomState(seed)
    wd = rng.randn(q.shape[0], H).astype(np.float32)
    wn = rng.randn(*q.shape).astype(np.float32)
    want = _pallas_terms_and_grads(tiles, q, k, v, rm, H, wd, wn)
    got = _port_terms_and_grads(tiles, q, k, v, rm, H, wd, wn)
    for name, g, w in zip(("den", "num", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(
            g, w, **(TERMS_TOL if name in ("den", "num") else GRAD_TOL),
            err_msg=name)
    return rm_t


@pytest.mark.parametrize("case", CASES)
def test_plain_versions_match_pallas(case):
    nr, nc, n_out, H, nnz, bm, bk = case
    rng, q, k, v = _inputs(0, nr, nc, n_out, H)
    rows, cols = _rand_edges(rng, nr, nc, nnz)
    tiles = tes.pack_edge_tiles(rows, cols, nr, nc, bm=bm, bk=bk, ecap=128)
    rm = _check_against_pallas(tiles, q, k, v, H, seed=1)
    has_edge = np.zeros(nr, bool)
    has_edge[rows] = True
    assert (rm[~has_edge] == tea.NEG_SENTINEL).all()
    assert (rm[has_edge] > tea.NEG_SENTINEL / 2).all()


@pytest.mark.parametrize("H", [1, 4])
def test_gradients_match_jax_grad(H):
    """dq, dk, dv through the port's autograd.Function vs jax.grad
    through the Pallas custom VJP, bucket-padded tiles (pad entries and
    tail coord rows stay inert)."""
    nr, nc, n_out = 128, 256, 64
    rng, q, k, v = _inputs(1, nr, nc, n_out, H)
    rows, cols = _rand_edges(rng, nr, nc, 500)
    t = tes.pack_edge_tiles(rows, cols, nr, nc, bm=128, bk=128, ecap=128)
    c2, rc2, off2, ord2, _ = tes.repad_tiles(
        t.coords, t.blk_rc, t.off, t.t_order, t.blk_rc.shape[0] + 24,
        t.coords.shape[0] + 4, nr // 128, nc // 128)
    tiles = tes.EdgeTiles(coords=c2, blk_rc=rc2, off=off2, t_order=ord2,
                          nrows=nr, ncols=nc, bm=128, bk=128, ecap=128)
    _check_against_pallas(tiles, q, k, v, H, seed=2)


def test_empty_tile_rows_and_cols_are_inert():
    """Edges in one (rt, ct) tile only: every other row tile is reached
    through sentinel entries alone and reads NEG_SENTINEL / exact zeros;
    the columns outside the tile get exact-zero gradients."""
    nr, nc, n_out, H = 256, 384, 32, 2
    rng, q, k, v = _inputs(2, nr, nc, n_out, H)
    rows = rng.randint(0, 128, 40).astype(np.int64)
    cols = (256 + rng.randint(0, 128, 40)).astype(np.int64)
    _, ui = np.unique(rows * nc + cols, return_index=True)
    tiles = tes.pack_edge_tiles(rows[ui], cols[ui], nr, nc, bm=128, bk=128)
    rm = _check_against_pallas(tiles, q, k, v, H, seed=3)
    assert (rm[128:] == tea.NEG_SENTINEL).all()
    wd = np.ones((nr, H), np.float32)
    wn = np.ones((nr, n_out), np.float32)
    den, num, dq, dk, dv = _port_terms_and_grads(
        tiles, q, k, v, _finite_rowmax(rm), H, wd, wn)
    assert (den[128:] == 0).all() and (num[128:] == 0).all()
    assert (dq[128:] == 0).all()
    assert (dk[:256] == 0).all() and (dv[:256] == 0).all()


def _poke_row_past_tile(tiles):
    """Overwrite one packed coord of a 128 x 256 tile set with a local row
    in [128, 256): the TPU kernel's one-hot drops it."""
    assert (tiles.bm, tiles.bk) == (128, 256)
    ent = int(np.flatnonzero(tiles.off[1] > 0)[0])
    flat = tiles.coords.reshape(-1)
    flat[tiles.off[0, ent]] = np.uint16((200 << 8) | 7).view(np.int16)


@pytest.mark.parametrize("ecap", [64, 2048])
def test_repeated_edges_count_once(ecap):
    """A coordinate repeated within one entry counts once (Pallas:
    ``A01 > 0``); with ``ecap`` 64 the heavy tiles split, and a repeat in
    another entry of the same tile counts again in both packages (2048,
    the largest cap, splits none). A local
    row past the tile is dropped."""
    nr, nc, n_out, H = 256, 512, 32, 2
    rng, q, k, v = _inputs(4, nr, nc, n_out, H)
    rows, cols = _rand_edges(rng, nr, nc, 1500)
    rep = rng.randint(0, len(rows), 300)
    rows = np.concatenate([rows, rows[rep], rows[rep[:50]]])
    cols = np.concatenate([cols, cols[rep], cols[rep[:50]]])
    tiles = tes.pack_edge_tiles(rows, cols, nr, nc, bm=128, bk=256,
                                ecap=ecap)
    _poke_row_past_tile(tiles)
    _check_against_pallas(tiles, q, k, v, H, seed=5)
    # the plain versions count the live, distinct (entry, row, col) edges
    r, c = tea.live_edges(*_t(tiles)[:3], 128, 256)
    assert len(r) < len(rows) - 1
    if ecap == 2048:   # no tile splits: each pair counts once
        key = r * nc + c
        assert len(torch.unique(key)) == len(key)


@pytest.mark.parametrize("val_free", [True, False])
def test_resident_packers_emit_no_repeated_edge(small_graph, val_free):
    """The resident stream-tile payloads (the native cold slice's direct
    tiles when values are device-derivable, `pack_edge_tiles` otherwise)
    carry each (row, col) pair at most once, and every local row fits its
    tile."""
    from gnn_tpu_torch.ops.hotdense import HotSpec
    from gnn_tpu_torch.placement.engine import compute_sample_prob
    from gnn_tpu_torch.sampling.ladies import SamplerConfig, ladies_sample
    from gnn_tpu_torch.utils.normalize import build_laplacian

    g = small_graph
    lap = build_laplacian(g.adj_full, "graphsage")
    spec = HotSpec.from_sample_prob(
        compute_sample_prob(lap, g.train_nodes, 3), 256)
    cfg = SamplerConfig(batch_size=64, samp_num=256, orders=(1, 1, 1),
                        num_nodes=lap.shape[0], num_classes=g.num_classes,
                        adj_format="resident", hot_spec=spec,
                        resident_val_free=val_free,
                        resident_stream_tiles=True)
    n_edges = 0
    for seed in range(3):
        mb = ladies_sample(cfg, seed, g.train_nodes[64 * seed:][:64], lap,
                           g.labels)
        for ref in mb.adjs:
            tiles = tes.EdgeTiles(
                coords=torch.from_numpy(ref.es_coords),
                blk_rc=torch.from_numpy(ref.es_rc),
                off=torch.from_numpy(ref.es_off), t_order=None,
                nrows=ref.nrows, ncols=ref.ncols, bm=ref.es_bm,
                bk=ref.es_bk, ecap=tes.ECAP)
            rows, cols, w = tes.decode_edges(tiles)
            assert (w == 1).all()   # every local row fits its tile
            key = rows * ref.ncols + cols
            assert len(torch.unique(key)) == len(key)
            n_edges += len(key)
    assert n_edges > 1000


# --- the CUDA kernels on the card ---------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    return torch.device("cuda")


def _cuda_vs_plain(tiles, q, k, v, H, dev, seed, compare_terms=True):
    """Each of the four kernels against its plain version on the card.
    With ``compare_terms`` False only the row max is compared and the
    terms and gradients must be finite: at scores of ~1e4 one float32
    rounding step of a score moves exp(s - row_max) by ~1e-3."""
    ct = _t(tiles, dev)
    qd, kd, vd = (torch.from_numpy(a).to(dev) for a in (q, k, v))
    kw = dict(n_heads=H, bm=tiles.bm, bk=tiles.bk)
    before = dict(tea.launches)
    rm = tea.cold_attention_rowmax(*ct[:3], qd, kd, **kw)
    torch.testing.assert_close(
        rm, tea.cold_attention_rowmax_ref(*ct[:3], qd, kd, **kw), **RM_TOL)
    rm = torch.where(rm > tea.NEG_SENTINEL / 2, rm, torch.zeros_like(rm))
    g = torch.Generator(device=dev).manual_seed(seed)
    gd = torch.randn(rm.shape, generator=g, device=dev)
    gn = torch.randn(qd.shape, generator=g, device=dev)
    qg, kg, vg = (a.clone().requires_grad_() for a in (qd, kd, vd))
    den, num = tea.cold_attention_terms(*ct, qg, kg, vg, rm, **kw)
    ((den * gd).sum() + (num * gn).sum()).backward()
    want = tea.cold_attention_terms_ref(*ct, qd, kd, vd, rm, **kw)
    dq = tea.cold_attention_bwd_q_ref(*ct, qd, kd, vd, rm, gd, gn, **kw)
    dk, dv = tea.cold_attention_bwd_kv_ref(*ct, qd, kd, vd, rm, gd, gn, **kw)
    torch.cuda.synchronize()
    for name, a, b in (("den", den, want[0]), ("num", num, want[1]),
                       ("dq", qg.grad, dq), ("dk", kg.grad, dk),
                       ("dv", vg.grad, dv)):
        assert torch.isfinite(a).all(), name
        if compare_terms:
            tol = TERMS_TOL if name in ("den", "num") else GRAD_TOL
            torch.testing.assert_close(a, b, **tol, msg=name)
    for name in ("rowmax", "terms", "bwd_q", "bwd_kv"):
        assert tea.launches[name] == before.get(name, 0) + 1, name


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES[:2] + [
    (512, 768, 128, 1, 6000, 256, 256),
    (512, 512, 64, 4, 4000, 256, 128),
])
def test_cuda_kernels_match_plain_versions(cuda_device, case):
    nr, nc, n_out, H, nnz, bm, bk = case
    rng, q, k, v = _inputs(6, nr, nc, n_out, H)
    rows, cols = _rand_edges(rng, nr, nc, nnz)
    tiles = tes.pack_edge_tiles(rows, cols, nr, nc, bm=bm, bk=bk)
    _cuda_vs_plain(tiles, q, k, v, H, cuda_device, seed=0)


@pytest.mark.cuda
def test_cuda_kernels_count_repeats_once(cuda_device):
    nr, nc, n_out, H = 256, 512, 64, 2
    rng, q, k, v = _inputs(7, nr, nc, n_out, H)
    rows, cols = _rand_edges(rng, nr, nc, 1500)
    rep = rng.randint(0, len(rows), 300)
    tiles = tes.pack_edge_tiles(np.concatenate([rows, rows[rep]]),
                                np.concatenate([cols, cols[rep]]), nr, nc,
                                bm=128, bk=256, ecap=64)
    _poke_row_past_tile(tiles)
    _cuda_vs_plain(tiles, q, k, v, H, cuda_device, seed=1)


@pytest.mark.cuda
def test_cuda_kernels_finite_at_large_magnitudes(cuda_device):
    """Scores far past exp's float32 range (inputs x50): masked and
    underflowing terms give exact zeros, never NaN."""
    nr, nc, n_out, H = 256, 512, 64, 2
    rng, q, k, v = _inputs(8, nr, nc, n_out, H, scale=50.0)
    rows, cols = _rand_edges(rng, nr, nc, 3000)
    tiles = tes.pack_edge_tiles(rows, cols, nr, nc, bm=256, bk=256)
    _cuda_vs_plain(tiles, q, k, v, H, cuda_device, seed=2,
                   compare_terms=False)


# --- the cases of the card kernel's core: a hub row (and a hub column),
# a row tile over one pass, a one-tile input split over a cluster with
# repeats inside its entries, several heads (d = 16, H = 2 with a local
# row past the tile, an odd head width d = 9), an empty row and column
# tile, a width over 512 (32 floats a lane). q and k are small binary
# fractions, so every score is exact in any summation order and the row
# max must agree exactly; the terms and gradients sum exponentials and
# are held to TERMS_TOL / GRAD_TOL. ---

# name: nr, nc, n_out, H, bm, bk, ecap
CORE_CASES = {
    # row 7 has 2000 edges over 16 col tiles, col 11 has 300 over 4 row
    # tiles
    "hub": (512, 2048, 32, 1, 128, 128, 128),
    # 13k edges in one row tile, entries of 2048: more than one pass
    "multi_pass": (256, 1024, 64, 1, 256, 256, 2048),
    # one 256 x 256 tile (13k edges + repeats next to their originals, so
    # within one entry): its edges split over a cluster
    "one_tile_repeats": (256, 256, 64, 1, 256, 256, 2048),
    "heads4_d16": (256, 512, 64, 4, 128, 128, 128),
    # a packed local row in [128, 256) of a 128 x 256 tile is dropped
    "heads2_row_past_tile": (256, 512, 32, 2, 128, 256, 256),
    "odd_head_width": (256, 256, 36, 4, 128, 128, 128),
    # no edge in row tile 1 nor in col tile 1
    "empty_tile": (768, 768, 64, 1, 256, 256, 256),
    "wide": (256, 512, 640, 1, 256, 256, 256),
}


def _core_case(name):
    """``(tiles_np, q, k, v)`` of a CORE_CASES case."""
    nr, nc, n_out, H, bm, bk, ecap = CORE_CASES[name]
    rng = np.random.RandomState(40 + sorted(CORE_CASES).index(name))
    if name == "hub":
        m = rng.rand(nr, nc) < 2e-3
        m[7, rng.choice(nc, 2000, replace=False)] = True
        m[rng.choice(nr, 300, replace=False), 11] = True
    elif name == "empty_tile":
        m = rng.rand(nr, nc) < 0.03
        m[256:512] = False
        m[:, 256:512] = False
    else:
        dens = {"multi_pass": 0.05, "one_tile_repeats": 0.2}.get(name, 0.03)
        m = rng.rand(nr, nc) < dens
    rows, cols = np.nonzero(m)
    if name == "one_tile_repeats":
        rep = np.arange(0, len(rows), 7)
        rows = np.insert(rows, rep + 1, rows[rep])
        cols = np.insert(cols, rep + 1, cols[rep])
    tiles = tes.pack_edge_tiles(rows, cols, nr, nc, bm=bm, bk=bk, ecap=ecap)
    if name == "heads2_row_past_tile":
        _poke_row_past_tile(tiles)
    q = (rng.randint(-4, 5, (nr, n_out)) / 8).astype(np.float32)
    k = (rng.randint(-4, 5, (nc, n_out)) / 8).astype(np.float32)
    v = (rng.randint(-4, 5, (nc, n_out)) / 8).astype(np.float32)
    return tiles, q, k, v


def test_core_cases_hold_what_they_name():
    """The core cases' packs have what their names promise: repeats
    inside entries, a dropped row, an entry of 2048 edges and a row tile
    over a 4 x 2048-edge pass."""
    tiles, *_ = _core_case("one_tile_repeats")
    r, _ = tea.live_edges(*_t(tiles)[:3], 256, 256)
    assert len(r) < int(tiles.off[1].sum())
    tiles, *_ = _core_case("heads2_row_past_tile")
    r, _ = tea.live_edges(*_t(tiles)[:3], 128, 256)
    assert len(r) < int(tiles.off[1].sum())
    tiles, *_ = _core_case("multi_pass")
    assert tiles.off[1].max() == 2048 and tiles.off[1].sum() > 4 * 2048


@pytest.mark.parametrize("name", list(CORE_CASES))
def test_core_case_plain_versions_match_pallas(name):
    """The plain versions against the Pallas kernel in interpret mode on
    the card kernel's core cases: row max, terms and the three
    gradients."""
    tiles, q, k, v = _core_case(name)
    H = CORE_CASES[name][3]
    _check_against_pallas(tiles, q, k, v, H, seed=7)


def _kernel_launches(fn):
    """The CUDA kernels ``fn()`` launches, by name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "edge_attention_kernel" in e.name]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CORE_CASES))
def test_cuda_core_case_matches_plain_version(cuda_device, name):
    """The four kernels on the card against their plain versions on the
    core cases; the row max exactly (its scores are exact), each entry
    point with exactly one kernel launch."""
    tiles, q, k, v = _core_case(name)
    H = CORE_CASES[name][3]
    dev = cuda_device
    ct = _t(tiles, dev)
    qd, kd, vd = (torch.from_numpy(a).to(dev) for a in (q, k, v))
    kw = dict(n_heads=H, bm=tiles.bm, bk=tiles.bk)
    rm = tea.cold_attention_rowmax(*ct[:3], qd, kd, **kw)
    torch.testing.assert_close(
        rm, tea.cold_attention_rowmax_ref(*ct[:3], qd, kd, **kw), rtol=0,
        atol=0)
    rm = torch.where(rm > tea.NEG_SENTINEL / 2, rm, torch.zeros_like(rm))
    g = np.random.RandomState(3)
    gd = torch.from_numpy((g.randint(-4, 5, rm.shape) / 8).astype(
        np.float32)).to(dev)
    gn = torch.from_numpy((g.randint(-4, 5, q.shape) / 8).astype(
        np.float32)).to(dev)
    calls = {
        "rowmax": (lambda: (tea.cold_attention_rowmax(*ct[:3], qd, kd,
                                                      **kw),),
                   None),
        "terms": (lambda: tea.cold_attention_terms(*ct, qd, kd, vd, rm, **kw),
                  lambda: tea.cold_attention_terms_ref(*ct, qd, kd, vd, rm,
                                                       **kw)),
        "bwd_q": (lambda: (tea.cold_attention_bwd_q(*ct, qd, kd, vd, rm, gd,
                                                    gn, **kw),),
                  lambda: (tea.cold_attention_bwd_q_ref(*ct, qd, kd, vd, rm,
                                                        gd, gn, **kw),)),
        "bwd_kv": (lambda: tea.cold_attention_bwd_kv(*ct, qd, kd, vd, rm, gd,
                                                     gn, **kw),
                   lambda: tea.cold_attention_bwd_kv_ref(*ct, qd, kd, vd, rm,
                                                         gd, gn, **kw)),
    }
    for key, (kern, plain) in calls.items():
        before = tea.launches[key]
        assert len(_kernel_launches(kern)) == 1, key
        assert tea.launches[key] == before + 1, key
        if plain is None:
            continue
        got, want = kern(), plain()
        torch.cuda.synchronize()
        tol = TERMS_TOL if key == "terms" else GRAD_TOL
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.isfinite(a).all(), (key, i)
            torch.testing.assert_close(a, b, **tol, msg=f"{key} {i}")
    if name == "one_tile_repeats":
        # one output tile: its edges split over a cluster
        assert tea.launch_blocks(ct[0], 1, q.shape[1])[1] > 1
    if name == "empty_tile":
        den, num = calls["terms"][0]()
        assert (den[256:512] == 0).all() and (num[256:512] == 0).all()
        dk, dv = calls["bwd_kv"][0]()
        assert (dk[256:512] == 0).all() and (dv[256:512] == 0).all()
