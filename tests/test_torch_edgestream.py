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
