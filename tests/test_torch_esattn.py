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
  kernel's ``A01 > 0`` mask counts it; the resident packers never emit a
  repeated pair, which the per-edge CUDA kernel's first pass also
  checks.
* On a machine with a card, the CUDA kernels must match the plain
  versions (``-m cuda``; this module imports JAX only inside the parity
  helpers, so ``pytest --noconftest -m cuda`` runs it where JAX is
  absent).
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
