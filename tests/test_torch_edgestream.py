"""The edge-stream SpMM of the PyTorch port (gnn_tpu_torch.ops.edgestream)
against the JAX package's (gnn_tpu.ops.pallas_edgestream).

* The host packers must give arrays EQUAL to the JAX package's.
* The plain PyTorch version must match the Pallas kernel run in
  interpret mode on the same packed tiles and inputs. Tolerance: rtol =
  atol = 1e-5 — both sum the same float32 products, in another order.
* On a machine with a card, the CUDA kernel must match the plain
  version (``-m cuda``; this module imports JAX only inside the parity
  tests, so ``pytest --noconftest -m cuda`` runs it where JAX is absent).
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gnn_tpu_torch.ops import edgestream as tes

TOL = dict(rtol=1e-5, atol=1e-5)


def _edges(seed, nr, nc, dens, dup=False):
    rng = np.random.RandomState(seed)
    m = sp.random(nr, nc, density=dens, format="coo", random_state=rng,
                  dtype=np.float32)
    rows, cols = m.row.astype(np.int64), m.col.astype(np.int64)
    if not dup:
        _, ui = np.unique(rows * nc + cols, return_index=True)
        rows, cols = rows[ui], cols[ui]
    o = np.lexsort((cols, rows))
    return rng, rows[o], cols[o]


def _pallas(tiles_np, x, rv, nf, transpose):
    """The JAX package's Pallas kernel in interpret mode on the same
    packed arrays (vals ride as float32)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from gnn_tpu.ops.pallas_edgestream import EdgeTiles, edge_stream_spmm
    t = EdgeTiles(coords=jnp.asarray(tiles_np.coords),
                  blk_rc=jnp.asarray(tiles_np.blk_rc),
                  off=jnp.asarray(tiles_np.off),
                  t_order=jnp.asarray(tiles_np.t_order),
                  nrows=tiles_np.nrows, ncols=tiles_np.ncols,
                  bm=tiles_np.bm, bk=tiles_np.bk, ecap=tiles_np.ecap,
                  vals=None if tiles_np.vals is None
                  else jnp.asarray(tiles_np.vals, jnp.float32))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(edge_stream_spmm(
            t, jnp.asarray(x), jnp.asarray(rv), jnp.asarray(nf),
            transpose=transpose, interpret=True))


def _to_torch(tiles, device="cpu"):
    return tes.EdgeTiles(**{
        k: (torch.from_numpy(np.ascontiguousarray(v)).to(device)
            if isinstance(v, np.ndarray) else v)
        for k, v in tiles.__dict__.items()})


def _assert_same_pack(t_np, j):
    for f in ("coords", "blk_rc", "off", "t_order"):
        np.testing.assert_array_equal(getattr(t_np, f),
                                      np.asarray(getattr(j, f)),
                                      err_msg=f)
    assert (t_np.nrows, t_np.ncols, t_np.bm, t_np.bk, t_np.ecap) == \
        (j.nrows, j.ncols, j.bm, j.bk, j.ecap)


CASES = [
    # nr, nc, f, density, ecap, bm, bk, with per-edge vals
    (128, 256, 128, 0.05, 64, 128, 128, False),
    (384, 128, 160, 0.30, 128, 128, 128, False),  # heavy tiles split
    (256, 512, 100, 0.04, 256, 256, 256, False),  # sign-bit coords, F%128
    (512, 256, 96, 0.10, 256, 128, 256, False),
    (256, 512, 96, 0.03, 256, 256, 256, True),    # per-edge values
]


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_packers_match_jax(case, use_native):
    from gnn_tpu.ops import pallas_edgestream as jes
    nr, nc, _, dens, ecap, bm, bk, has_vals = case
    rng, rows, cols = _edges(0, nr, nc, dens)
    vals = (rng.rand(len(rows)) + 0.5).astype(np.float32) \
        if has_vals else None
    kw = dict(bm=bm, bk=bk, ecap=ecap, use_native=use_native, vals=vals,
              val_dtype=np.float32)
    t = tes.pack_edge_tiles(rows, cols, nr, nc, **kw)
    j = jes.pack_edge_tiles(rows, cols, nr, nc, **kw)
    _assert_same_pack(t, j)
    if has_vals:
        np.testing.assert_array_equal(t.vals, np.asarray(j.vals))
        # the JAX default stores bfloat16; the port the same values in f32
        tb = tes.pack_edge_tiles(rows, cols, nr, nc, bm=bm, bk=bk,
                                 ecap=ecap, use_native=use_native,
                                 vals=vals)
        jb = jes.pack_edge_tiles(rows, cols, nr, nc, bm=bm, bk=bk,
                                 ecap=ecap, use_native=use_native,
                                 vals=vals)
        np.testing.assert_array_equal(
            tb.vals, np.asarray(jb.vals).astype(np.float32))
    # bucketed padding and re-padding
    nb = t.blk_rc.shape[0]
    tp = tes.pack_edge_tiles(rows, cols, nr, nc, nb_pad=nb + 37,
                             e_pad=len(rows) + 300, **kw)
    jp = jes.pack_edge_tiles(rows, cols, nr, nc, nb_pad=nb + 37,
                             e_pad=len(rows) + 300, **kw)
    _assert_same_pack(tp, jp)
    args = (t.coords, t.blk_rc, t.off, t.t_order, nb + 100,
            t.coords.shape[0] + 8, nr // bm, nc // bk)
    r_t = tes.repad_tiles(*args, vals=t.vals)
    r_j = jes.repad_tiles(*args, vals=t.vals)
    for a, b in zip(r_t, r_j):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, np.asarray(b))
    for nrp, ncp in [(128, 128), (256, 384), (512, 1024), (384, 256)]:
        assert tes.tile_dims(nrp, ncp) == jes.tile_dims(nrp, ncp)


def test_build_tiles_matches_jax():
    """_build_tiles straight from tile-sorted coords and counts (the
    native direct-to-tiles path) gives the JAX package's tables."""
    from gnn_tpu.ops import pallas_edgestream as jes
    rng = np.random.RandomState(3)
    n_rt, n_ct = 3, 5
    counts = rng.randint(0, 600, n_rt * n_ct)
    counts[[2, 7]] = 0
    coords = rng.randint(-2 ** 15, 2 ** 15, counts.sum()).astype(np.int16)
    occ = np.flatnonzero(counts)
    for e_pad in (None, int(counts.sum()) + 512):
        a = tes._build_tiles(coords, occ, counts[occ], n_rt * 128,
                             n_ct * 256, 128, 256, 256, n_rt, n_ct, None,
                             e_pad)
        b = jes._build_tiles(coords, occ, counts[occ], n_rt * 128,
                             n_ct * 256, 128, 256, 256, n_rt, n_ct, None,
                             e_pad)
        _assert_same_pack(a, b)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_pallas(case, transpose):
    nr, nc, f, dens, ecap, bm, bk, has_vals = case
    rng, rows, cols = _edges(1, nr, nc, dens)
    vals = (rng.rand(len(rows)) + 0.5).astype(np.float32) \
        if has_vals else None
    tiles = tes.pack_edge_tiles(rows, cols, nr, nc, bm=bm, bk=bk,
                                ecap=ecap, vals=vals, val_dtype=np.float32)
    # bucketed: pad entries and tail coord rows must stay inert
    c2, rc2, off2, ord2, v2 = tes.repad_tiles(
        tiles.coords, tiles.blk_rc, tiles.off, tiles.t_order,
        tiles.blk_rc.shape[0] + 24, tiles.coords.shape[0] + 4, nr // bm,
        nc // bk, vals=tiles.vals)
    tiles = tes.EdgeTiles(coords=c2, blk_rc=rc2, off=off2, t_order=ord2,
                          nrows=nr, ncols=nc, bm=bm, bk=bk, ecap=ecap,
                          vals=v2)
    rv = (rng.rand(nr) + 0.5).astype(np.float32)
    nf = (rng.rand(nc) + 0.5).astype(np.float32)
    x = rng.randn(nr if transpose else nc, f).astype(np.float32)
    want = _pallas(tiles, x, rv, nf, transpose)
    got = tes.edge_stream_spmm(_to_torch(tiles), torch.from_numpy(x),
                               torch.from_numpy(rv), torch.from_numpy(nf),
                               transpose=transpose)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_version_empty_sparse_and_duplicates():
    """Edges in one row tile and one col tile only (every other output
    tile is a zero sentinel), a fully empty edge set, and duplicate
    edges (which sum)."""
    rng = np.random.RandomState(4)
    nr, nc, f = 256, 384, 128
    rows = np.sort(rng.randint(0, 128, 40)).astype(np.int64)
    cols = (256 + rng.randint(0, 128, 40)).astype(np.int64)
    rows = np.concatenate([rows, rows[:5]])   # duplicates
    cols = np.concatenate([cols, cols[:5]])
    tiles = tes.pack_edge_tiles(rows, cols, nr, nc)
    rv = np.ones(nr, np.float32)
    nf = np.ones(nc, np.float32)
    for transpose in (False, True):
        x = rng.randn(nr if transpose else nc, f).astype(np.float32)
        want = _pallas(tiles, x, rv, nf, transpose)
        got = tes.edge_stream_spmm(_to_torch(tiles), torch.from_numpy(x),
                                   torch.from_numpy(rv),
                                   torch.from_numpy(nf), transpose)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    t0 = tes.pack_edge_tiles(np.zeros(0, np.int64), np.zeros(0, np.int64),
                             128, 128)
    y0 = tes.edge_stream_spmm(_to_torch(t0), torch.ones(128, 8),
                              torch.ones(128), torch.ones(128))
    assert torch.count_nonzero(y0) == 0



# --- the cases of the card kernel's core: a hub row, output tiles over
# one staging pass, F = 602 / odd / below 32, per-edge values, an empty
# output tile, a one-tile input that splits over a cluster. Inputs are
# small binary fractions (x in k/8, factors and values in {0.5, 1, 1.5,
# 2}), so every sum is exact in float32 in any order and the kernel must
# agree with the plain version and the Pallas kernel to rounding-free
# precision; TOL (1e-5) is the bound asserted. ---

# name: nr, nc, f, bm, bk, ecap, with per-edge values
CORE_CASES = {
    # row 7 has 5000 edges over 20 col tiles, col 11 has 5000 over 20 row
    # tiles: a hub output row in each direction, longer than a pass
    "hub": (5120, 5120, 96, 256, 256, 256, False),
    # 13k edges in one row tile (> the 4096-edge pass, 2 entry windows
    # at ecap 32); F = 602 takes float2 loads
    "multi_pass_f602": (256, 1024, 602, 256, 256, 32, False),
    "odd_f": (384, 512, 37, 128, 256, 256, False),
    "narrow_f_vals": (512, 256, 8, 256, 128, 256, True),
    # no edge in row tile 1 nor in col tile 1
    "empty_tile": (768, 768, 64, 256, 256, 256, False),
    # one 256 x 256 tile: one output tile, so its edges split over blocks
    "one_tile": (256, 256, 64, 256, 256, 64, False),
}


def _core_case(name, dup=False):
    """``(tiles_np, rows, cols, vals, rv, nf, x, g)`` of a CORE_CASES
    case: numpy pack, edges, factors, the forward input ``x`` and the
    transpose's ``g``."""
    nr, nc, f, bm, bk, ecap, has_vals = CORE_CASES[name]
    rng = np.random.RandomState(20 + sorted(CORE_CASES).index(name))
    if name == "hub":
        bg = rng.rand(nr, nc) < 5e-4
        bg[7, rng.choice(nc, 5000, replace=False)] = True
        bg[rng.choice(nr, 5000, replace=False), 11] = True
        rows, cols = np.nonzero(bg)
    elif name == "empty_tile":
        m = rng.rand(nr, nc) < 0.05
        m[256:512] = False
        m[:, 256:512] = False
        rows, cols = np.nonzero(m)
    else:
        dens = {"multi_pass_f602": 0.05, "odd_f": 0.05,
                "narrow_f_vals": 0.1, "one_tile": 0.2}[name]
        rows, cols = np.nonzero(rng.rand(nr, nc) < dens)
    if dup:
        rows = np.concatenate([rows, rows[::7]])
        cols = np.concatenate([cols, cols[::7]])
    vals = rng.choice([0.5, 1.0, 1.5, 2.0], len(rows)).astype(np.float32) \
        if has_vals else None
    tiles = tes.pack_edge_tiles(rows, cols, nr, nc, bm=bm, bk=bk, ecap=ecap,
                                vals=vals, val_dtype=np.float32)
    rv = rng.choice([0.5, 1.0, 2.0], nr).astype(np.float32)
    nf = rng.choice([0.5, 1.0, 2.0], nc).astype(np.float32)
    x = (rng.randint(-4, 5, (nc, f)) / 8).astype(np.float32)
    g = (rng.randint(-4, 5, (nr, f)) / 8).astype(np.float32)
    return tiles, rows, cols, vals, rv, nf, x, g


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("name", list(CORE_CASES))
def test_core_case_plain_version_matches_pallas(name, transpose):
    """The plain version against the Pallas kernel in interpret mode on
    the card kernel's core cases, both orientations."""
    tiles, _, _, _, rv, nf, x, g = _core_case(name)
    inp = g if transpose else x
    want = _pallas(tiles, inp, rv, nf, transpose)
    got = tes.edge_stream_spmm(_to_torch(tiles), torch.from_numpy(inp),
                               torch.from_numpy(rv), torch.from_numpy(nf),
                               transpose=transpose)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", list(CORE_CASES))
def test_core_case_seg_plain_equals_k1_plain(name):
    """K6's plain version on the core cases' packs (without values) and
    on the swapped packs gives K1's forward and transpose."""
    _, rows, cols, _, rv, nf, x, g = _core_case(name)
    nr, nc, _, bm, bk, ecap, _ = CORE_CASES[name]
    tiles = tes.pack_edge_tiles(rows, cols, nr, nc, bm=bm, bk=bk, ecap=ecap)
    segp = tes.segment_tiles(tiles.blk_rc, tiles.off)
    k1 = tes.edge_stream_spmm(_to_torch(tiles), torch.from_numpy(x),
                              torch.from_numpy(rv), torch.from_numpy(nf))
    np.testing.assert_allclose(_seg_torch(tiles, segp, x, rv, nf).numpy(),
                               k1.numpy(), **TOL)
    k1_t = tes.edge_stream_spmm(_to_torch(tiles), torch.from_numpy(g),
                                torch.from_numpy(rv), torch.from_numpy(nf),
                                transpose=True)
    tiles_t = _swapped(rows, cols, nr, nc, bm, bk)
    segp_t = tes.segment_tiles(tiles_t.blk_rc, tiles_t.off)
    np.testing.assert_allclose(
        _seg_torch(tiles_t, segp_t, g, nf, rv).numpy(), k1_t.numpy(), **TOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_plain_version(cuda_device, case, transpose):
    """The CUDA kernel vs the plain version on the card. Tolerance
    1e-5: shared-memory atomics sum the same float32 products in an
    order that varies from run to run."""
    nr, nc, f, dens, ecap, bm, bk, has_vals = case
    rng, rows, cols = _edges(2, nr, nc, dens, dup=True)
    vals = (rng.rand(len(rows)) + 0.5).astype(np.float32) \
        if has_vals else None
    tiles = _to_torch(tes.pack_edge_tiles(
        rows, cols, nr, nc, bm=bm, bk=bk, ecap=ecap, vals=vals,
        val_dtype=np.float32), cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    rv = torch.rand(nr, generator=g, device=cuda_device) + 0.5
    nf = torch.rand(nc, generator=g, device=cuda_device) + 0.5
    x = torch.randn(nr if transpose else nc, f, generator=g,
                    device=cuda_device)
    before = tes.launches["transpose" if transpose else "forward"]
    got = tes.edge_stream_spmm(tiles, x, rv, nf, transpose)
    want = tes.edge_stream_spmm_ref(tiles, x, rv, nf, transpose)
    torch.cuda.synchronize()
    assert tes.launches["transpose" if transpose else "forward"] == \
        before + 1
    torch.testing.assert_close(got, want, **TOL)


# --- the segment-grid SpMM (K6) ---

def _seg_case(seed):
    """The JAX package's K6 test case for ``seed`` (random tile dims, a
    few row/col tiles, up to 4% density, F 8 or 96)."""
    rng = np.random.RandomState(50 + seed)
    bm = int(rng.choice([128, 256]))
    bk = int(rng.choice([128, 256]))
    n_rt = rng.randint(1, 5)
    n_ct = rng.randint(1, 5)
    nr, nc = n_rt * bm, n_ct * bk
    nnz = rng.randint(0, max(nr * nc // 25, 2))
    key = rng.choice(nr * nc, size=nnz, replace=False) if nnz else \
        np.zeros(0, np.int64)
    rows = np.sort(key) // nc
    cols = np.sort(key) % nc
    rv = rng.rand(nr).astype(np.float32) + 0.5
    nf = rng.rand(nc).astype(np.float32) + 0.5
    f = int(rng.choice([8, 96]))
    x = rng.randn(nc, f).astype(np.float32)
    g = rng.randn(nr, f).astype(np.float32)
    return bm, bk, nr, nc, rows, cols, rv, nf, x, g


def _swapped(rows, cols, nr, nc, bm, bk):
    """The transpose's pack: (cols, rows) swapped, sorted row-major."""
    o = np.argsort(cols * nr + rows, kind="stable")
    return tes.pack_edge_tiles(cols[o], rows[o], nc, nr, bm=bk, bk=bm)


def _pallas_seg(tiles_np, segp, x, rv, nf):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from gnn_tpu.ops.pallas_edgestream import (EdgeTiles,
                                               edge_stream_spmm_seg)
    t = EdgeTiles(coords=jnp.asarray(tiles_np.coords),
                  blk_rc=jnp.asarray(tiles_np.blk_rc),
                  off=jnp.asarray(tiles_np.off),
                  t_order=jnp.asarray(tiles_np.t_order),
                  nrows=tiles_np.nrows, ncols=tiles_np.ncols,
                  bm=tiles_np.bm, bk=tiles_np.bk, ecap=tiles_np.ecap)
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(edge_stream_spmm_seg(
            t, jnp.asarray(segp), jnp.asarray(x), jnp.asarray(rv),
            jnp.asarray(nf), interpret=True))


def _seg_torch(tiles, segp, x, rv, nf, device="cpu"):
    return tes.edge_stream_spmm_seg(
        _to_torch(tiles, device), torch.from_numpy(segp).to(device),
        torch.from_numpy(x).to(device), torch.from_numpy(rv).to(device),
        torch.from_numpy(nf).to(device))


@pytest.mark.parametrize("case", CASES)
def test_segment_tiles_match_jax(case):
    """The same seg_ptr, array for array: default padding, a wider pad,
    and a too-small pad raises in both."""
    from gnn_tpu.ops import pallas_edgestream as jes
    nr, nc, _, dens, ecap, bm, bk, _ = case
    _, rows, cols = _edges(5, nr, nc, dens)
    t = tes.pack_edge_tiles(rows, cols, nr, nc, bm=bm, bk=bk, ecap=ecap,
                            nb_pad=None)
    a = tes.segment_tiles(t.blk_rc, t.off)
    np.testing.assert_array_equal(a, jes.segment_tiles(t.blk_rc, t.off))
    assert a.dtype == np.int32
    wide = len(a) + 20
    np.testing.assert_array_equal(tes.segment_tiles(t.blk_rc, t.off, wide),
                                  jes.segment_tiles(t.blk_rc, t.off, wide))
    ns = int(np.count_nonzero(a[:-1] < t.blk_rc.shape[0]))
    with pytest.raises(ValueError):
        tes.segment_tiles(t.blk_rc, t.off, ns - 1)


def test_segment_tiles_split_heavy_row_tiles_like_jax():
    """Row tiles whose edges overflow the coord window split into
    several segments, identically in both packages."""
    from gnn_tpu.ops import pallas_edgestream as jes
    _, rows, cols = _edges(6, 512, 1024, 0.15)
    t = tes.pack_edge_tiles(rows, cols, 512, 1024, bm=256, bk=256)
    a = tes.segment_tiles(t.blk_rc, t.off)
    np.testing.assert_array_equal(a, jes.segment_tiles(t.blk_rc, t.off))
    ns = int(np.count_nonzero(a[:-1] < t.blk_rc.shape[0]))
    assert ns > 2 * 2   # more segments than row tiles


@pytest.mark.parametrize("seed", range(4))
def test_seg_plain_version_matches_pallas(seed):
    """K6's plain version against the Pallas K6 in interpret mode: the
    forward on the pack, and the transpose as the same function on the
    (cols, rows)-swapped pack with the factors swapped. rtol = atol =
    1e-4 (the JAX test's: float32 sums in another order)."""
    bm, bk, nr, nc, rows, cols, rv, nf, x, g = _seg_case(seed)
    tiles = tes.pack_edge_tiles(rows, cols, nr, nc, bm=bm, bk=bk)
    segp = tes.segment_tiles(tiles.blk_rc, tiles.off)
    want = _pallas_seg(tiles, segp, x, rv, nf)
    got = _seg_torch(tiles, segp, x, rv, nf)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    tiles_t = _swapped(rows, cols, nr, nc, bm, bk)
    segp_t = tes.segment_tiles(tiles_t.blk_rc, tiles_t.off)
    want_t = _pallas_seg(tiles_t, segp_t, g, nf, rv)
    got_t = _seg_torch(tiles_t, segp_t, g, nf, rv)
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("heavy", [False, True])
def test_seg_plain_version_equals_k1_plain(heavy):
    """The same function as K1's forward (and, on the swapped pack, its
    transpose) on the same tiles, including row tiles split into several
    segments."""
    nr, nc, f, dens, bm, bk = ((512, 1024, 40, 0.15, 256, 256) if heavy
                               else (384, 512, 24, 0.05, 128, 256))
    rng, rows, cols = _edges(7, nr, nc, dens)
    rv = (rng.rand(nr) + 0.5).astype(np.float32)
    nf = (rng.rand(nc) + 0.5).astype(np.float32)
    x = rng.randn(nc, f).astype(np.float32)
    g = rng.randn(nr, f).astype(np.float32)
    tiles = tes.pack_edge_tiles(rows, cols, nr, nc, bm=bm, bk=bk)
    segp = tes.segment_tiles(tiles.blk_rc, tiles.off)
    k1 = tes.edge_stream_spmm(_to_torch(tiles), torch.from_numpy(x),
                              torch.from_numpy(rv), torch.from_numpy(nf))
    np.testing.assert_allclose(_seg_torch(tiles, segp, x, rv, nf).numpy(),
                               k1.numpy(), **TOL)
    k1_t = tes.edge_stream_spmm(_to_torch(tiles), torch.from_numpy(g),
                                torch.from_numpy(rv), torch.from_numpy(nf),
                                transpose=True)
    tiles_t = _swapped(rows, cols, nr, nc, bm, bk)
    segp_t = tes.segment_tiles(tiles_t.blk_rc, tiles_t.off)
    np.testing.assert_allclose(
        _seg_torch(tiles_t, segp_t, g, nf, rv).numpy(), k1_t.numpy(), **TOL)


def test_seg_rejects_per_edge_values():
    nr, nc, _, dens, ecap, bm, bk, _ = CASES[4]
    rng, rows, cols = _edges(8, nr, nc, dens)
    tiles = tes.pack_edge_tiles(rows, cols, nr, nc, bm=bm, bk=bk,
                                vals=(rng.rand(len(rows)) + 0.5).astype(
                                    np.float32))
    segp = tes.segment_tiles(tiles.blk_rc, tiles.off)
    with pytest.raises(ValueError, match="rank-1"):
        _seg_torch(tiles, segp, np.ones((nc, 4), np.float32),
                   np.ones(nr, np.float32), np.ones(nc, np.float32))


def test_seg_uncovered_row_tiles_read_zero():
    """A seg_ptr that covers only row tile 0 (every later segment empty)
    gives zeros on the other row tiles and K1's rows on row tile 0."""
    rng, rows, cols = _edges(9, 384, 256, 0.1)
    tiles = tes.pack_edge_tiles(rows, cols, 384, 256)
    segp = tes.segment_tiles(tiles.blk_rc, tiles.off)
    rt = tiles.blk_rc >> 16
    end0 = int(np.searchsorted(rt, 1))
    hand = np.full_like(segp, end0)
    hand[0] = 0
    x = rng.randn(256, 16).astype(np.float32)
    ones_r, ones_c = np.ones(384, np.float32), np.ones(256, np.float32)
    y = _seg_torch(tiles, hand, x, ones_r, ones_c).numpy()
    k1 = tes.edge_stream_spmm(_to_torch(tiles), torch.from_numpy(x),
                              torch.ones(384), torch.ones(256)).numpy()
    assert np.count_nonzero(y[128:]) == 0
    assert np.count_nonzero(k1[:128])
    np.testing.assert_allclose(y[:128], k1[:128], **TOL)


SEG_CUDA_CASES = [c for c in CASES if not c[7]] + [
    (512, 1024, 602, 0.15, 256, 256, 256, False)]   # split row tiles


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("case", SEG_CUDA_CASES)
def test_cuda_seg_kernel_matches_plain_version(cuda_device, case,
                                               transpose):
    """K6's CUDA kernel vs its plain version on the card, forward and on
    the swapped pack, with padding segments and duplicate edges.
    Tolerance: 1e-4 of the output's magnitude (``chip_smoke.py``'s
    REL_TOL): both sum up to a few hundred float32 products per row in
    orders that vary from run to run (shared-memory atomics; index_add_
    on the card), so an element that cancels can differ by more than
    1e-5 absolutely."""
    nr, nc, f, dens, ecap, bm, bk, _ = case
    rng, rows, cols = _edges(10, nr, nc, dens, dup=True)
    if transpose:
        tiles = _swapped(rows, cols, nr, nc, bm, bk)
        nr, nc = nc, nr
    else:
        tiles = tes.pack_edge_tiles(rows, cols, nr, nc, bm=bm, bk=bk)
    segp = tes.segment_tiles(tiles.blk_rc, tiles.off)
    segp = np.concatenate([segp, np.full(5, segp[-1], np.int32)])
    t = _to_torch(tiles, cuda_device)
    sp_t = torch.from_numpy(segp).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    rv = torch.rand(nr, generator=g, device=cuda_device) + 0.5
    nf = torch.rand(nc, generator=g, device=cuda_device) + 0.5
    x = torch.randn(nc, f, generator=g, device=cuda_device)
    before = tes.launches["seg"]
    got = tes.edge_stream_spmm_seg(t, sp_t, x, rv, nf)
    want = tes.edge_stream_spmm_seg_ref(t, sp_t, x, rv, nf)
    torch.cuda.synchronize()
    assert tes.launches["seg"] == before + 1
    _assert_rel_close(got, want)


def _assert_rel_close(got, want, rel=1e-4):
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    assert torch.isfinite(got).all() and err <= rel * scale + 1e-6, \
        (err, scale)


@pytest.mark.cuda
def test_cuda_seg_uncovered_row_tiles_read_zero(cuda_device):
    """On the card: a seg_ptr that covers only row tile 0 writes zeros on
    the other row tiles (empty segments in a shared row tile, and a row
    tile with no segment)."""
    rng, rows, cols = _edges(9, 384, 256, 0.1)
    tiles = tes.pack_edge_tiles(rows, cols, 384, 256)
    rt = tiles.blk_rc >> 16
    hand = np.full(9, int(np.searchsorted(rt, 1)), np.int32)
    hand[0] = 0
    t = _to_torch(tiles, cuda_device)
    sp_t = torch.from_numpy(hand).to(cuda_device)
    x = torch.from_numpy(rng.randn(256, 40).astype(np.float32)).to(
        cuda_device)
    ones_r = torch.ones(384, device=cuda_device)
    ones_c = torch.ones(256, device=cuda_device)
    got = tes.edge_stream_spmm_seg(t, sp_t, x, ones_r, ones_c)
    want = tes.edge_stream_spmm_seg_ref(t, sp_t, x, ones_r, ones_c)
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[128:]) == 0
    _assert_rel_close(got, want)



@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("name", list(CORE_CASES))
def test_cuda_core_case_matches_plain_version(cuda_device, name,
                                              transpose):
    """K1 (both orientations) and K6 (forward on the pack, transpose on
    the swapped pack) on the card against their plain versions on the
    core cases, with duplicate edges. The sums are exact (binary-fraction
    inputs), so TOL (1e-5) holds in any summation order."""
    tiles_np, rows, cols, _, rv, nf, x, g = _core_case(name, dup=True)
    nr, nc, f, bm, bk, ecap, _ = CORE_CASES[name]
    dev = cuda_device
    t = _to_torch(tiles_np, dev)
    rv_t, nf_t = torch.from_numpy(rv).to(dev), torch.from_numpy(nf).to(dev)
    inp = torch.from_numpy(g if transpose else x).to(dev)
    key = "transpose" if transpose else "forward"
    before = tes.launches[key]
    got = tes.edge_stream_spmm(t, inp, rv_t, nf_t, transpose)
    want = tes.edge_stream_spmm_ref(t, inp, rv_t, nf_t, transpose)
    torch.cuda.synchronize()
    assert tes.launches[key] == before + 1
    torch.testing.assert_close(got, want, **TOL)
    if name == "one_tile":
        # one output tile and one slab: its edges split over a cluster
        assert tes.launch_blocks(t, f, transpose) > 1
    # K6 on the rank-1 pack of the same edges, and K1 there
    plain = tes.pack_edge_tiles(rows, cols, nr, nc, bm=bm, bk=bk,
                                ecap=ecap)
    if transpose:
        seg_np, fr, fc = _swapped(rows, cols, nr, nc, bm, bk), nf_t, rv_t
    else:
        seg_np, fr, fc = plain, rv_t, nf_t
    segp = torch.from_numpy(tes.segment_tiles(seg_np.blk_rc,
                                              seg_np.off)).to(dev)
    ts = _to_torch(seg_np, dev)
    k1 = tes.edge_stream_spmm(_to_torch(plain, dev), inp, rv_t, nf_t,
                              transpose)
    before = tes.launches["seg"]
    got6 = tes.edge_stream_spmm_seg(ts, segp, inp, fr, fc)
    want6 = tes.edge_stream_spmm_seg_ref(ts, segp, inp, fr, fc)
    torch.cuda.synchronize()
    assert tes.launches["seg"] == before + 1
    torch.testing.assert_close(got6, want6, **TOL)
    torch.testing.assert_close(got6, k1, **TOL)


def test_probe_cases_hold_k6_against_k1_on_cpu(tmp_path):
    """``tools/torch_edgestream_probe.py``'s set-up on a small graph on
    the CPU: one resident stream-tile batch, and per layer the forward
    pack and the swapped pack with their seg_ptr, on which K6's plain
    version gives K1's forward and transpose."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "tools", "torch_edgestream_probe.py")
    spec = importlib.util.spec_from_file_location("probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    argv = ["--dataset", "synthetic:nodes=3000,deg=12,feats=16,classes=5",
            "--nhid", "16", "--orders", "1,1,1", "--samp_num", "512",
            "--batch_size", "256", "--hot_k", "512"]
    adjs, widths, ctx = probe.default_batch(str(tmp_path),
                                            torch.device("cpu"), argv)
    assert widths == [16, 32, 32] and ctx.orders == (1, 1, 1)
    cases = probe.seg_cases(adjs, widths)
    assert [c.layer for c in cases] == [0, 1, 2]
    g = torch.Generator().manual_seed(0)
    for c in cases:
        nb = c.tiles.blk_rc.shape[0]
        assert probe.n_segments(c.seg, nb) >= c.tiles.nrows // c.tiles.bm
        assert (c.tiles_t.nrows, c.tiles_t.ncols) == (c.tiles.ncols,
                                                      c.tiles.nrows)
        x = torch.randn(c.tiles.ncols, 6, generator=g)
        gy = torch.randn(c.tiles.nrows, 6, generator=g)
        torch.testing.assert_close(
            tes.edge_stream_spmm_seg(c.tiles, c.seg, x, c.rv, c.nf),
            tes.edge_stream_spmm(c.tiles, x, c.rv, c.nf), **TOL)
        torch.testing.assert_close(
            tes.edge_stream_spmm_seg(c.tiles_t, c.seg_t, gy, c.nf, c.rv),
            tes.edge_stream_spmm(c.tiles, gy, c.rv, c.nf, transpose=True),
            **TOL)
