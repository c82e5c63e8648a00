"""The stream SpMM (K2) of the PyTorch port (gnn_tpu_torch.ops.spmm)
against the JAX package's (gnn_tpu.ops.pallas_spmm).

* ``pack_stream`` must give arrays EQUAL to the JAX packer's.
* The plain PyTorch version must match the Pallas kernel run in
  interpret mode on the same packed stream and inputs, the transposed
  orientation a dense ``A^T @ x``, and the blocked adapter the JAX
  package's ``blocked_spmm_pallas`` (interpret). Tolerance: rtol = atol =
  1e-5 — the same float32 products, summed in another order.
* A tensor on a device that is neither the CPU nor a card raises.
* On a machine with a card, the CUDA kernel must match the plain version
  (``-m cuda``; JAX is imported only inside the parity tests, so ``pytest
  --noconftest -m cuda`` runs this module where JAX is absent).
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gnn_tpu_torch.ops import spmm as tsm

TOL = dict(rtol=1e-5, atol=1e-5)


def _coo(seed, nr, nc, dens, row_hi=None):
    """Unique random edges (rows below ``row_hi`` when given)."""
    rng = np.random.RandomState(seed)
    m = sp.random(row_hi or nr, nc, density=dens, format="coo",
                  random_state=rng, dtype=np.float32)
    return rng, m.row.astype(np.int64), m.col.astype(np.int64), \
        (m.data + 0.5).astype(np.float32)


def _to_torch(stream, device="cpu"):
    return tsm.StreamBlocks(**{
        k: (torch.from_numpy(np.ascontiguousarray(v)).to(device)
            if isinstance(v, np.ndarray) else v)
        for k, v in stream.__dict__.items()})


def _dense(stream):
    """The stream's matrix as a dense numpy array."""
    d = np.zeros((stream.nrows, stream.ncols), np.float32)
    for rc, tile in zip(stream.blk_rc, stream.vals):
        r, c = int(rc) >> 16, int(rc) & 0xFFFF
        d[r * stream.bm:(r + 1) * stream.bm,
          c * stream.bk:(c + 1) * stream.bk] += tile
    return d


def _pallas(stream, x):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from gnn_tpu.ops import pallas_spmm as jsm
    j = jsm.StreamBlocks(blk_rc=jnp.asarray(stream.blk_rc),
                         vals=jnp.asarray(stream.vals), nrows=stream.nrows,
                         ncols=stream.ncols, bm=stream.bm, bk=stream.bk)
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jsm.stream_spmm(j, jnp.asarray(x)))


# nr, nc, f, density, bm, rows populated below (None = all)
CASES = [
    (128, 256, 128, 0.05, 8, None),
    (256, 384, 96, 0.02, 128, None),
    (384, 128, 40, 0.30, 128, None),
    (128, 256, 64, 0.05, 8, 8),       # row tiles 1.. empty: sentinels
    (256, 256, 32, 0.0, 128, None),   # empty matrix
]


@pytest.mark.parametrize("case", CASES)
def test_pack_stream_matches_jax(case):
    from gnn_tpu.ops import pallas_spmm as jsm
    nr, nc, _, dens, bm, hi = case
    _, rows, cols, vals = _coo(0, nr, nc, dens, hi)
    t = tsm.pack_stream(rows, cols, vals, nr, nc, bm=bm, bk=128)
    j = jsm.pack_stream(rows, cols, vals, nr, nc, bm=bm, bk=128)
    np.testing.assert_array_equal(t.blk_rc, np.asarray(j.blk_rc))
    np.testing.assert_array_equal(t.vals, np.asarray(j.vals))
    assert (t.nrows, t.ncols, t.bm, t.bk) == (j.nrows, j.ncols, j.bm, j.bk)


@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_pallas_interpret(case):
    nr, nc, f, dens, bm, hi = case
    rng, rows, cols, vals = _coo(1, nr, nc, dens, hi)
    s = tsm.pack_stream(rows, cols, vals, nr, nc, bm=bm, bk=128)
    x = rng.randn(nc, f).astype(np.float32)
    got = tsm.stream_spmm(_to_torch(s), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _pallas(s, x), **TOL)
    np.testing.assert_allclose(got, _dense(s) @ x, **TOL)


@pytest.mark.parametrize("case", CASES)
def test_transpose_matches_dense(case):
    nr, nc, f, dens, bm, hi = case
    rng, rows, cols, vals = _coo(2, nr, nc, dens, hi)
    s = tsm.pack_stream(rows, cols, vals, nr, nc, bm=bm, bk=128)
    g = rng.randn(nr, f).astype(np.float32)
    ts = _to_torch(s)
    got = tsm.stream_spmm(ts, torch.from_numpy(g), transpose=True).numpy()
    np.testing.assert_allclose(got, _dense(s).T @ g, **TOL)
    # the column-tile visit order the wrapper sorts when none is given
    t_order = tsm.transpose_order(ts.blk_rc)
    assert torch.all(torch.diff(ts.blk_rc[t_order.long()] & 0xFFFF) >= 0)
    assert sorted(t_order.tolist()) == list(range(len(s.blk_rc)))
    ts.t_order = t_order
    np.testing.assert_allclose(tsm.stream_spmm(
        ts, torch.from_numpy(g), transpose=True).numpy(), got, **TOL)


def test_blocked_adapter_matches_jax():
    """``blocked_spmm`` over a BlockedAdj layout (padding tiles at column
    tile 0 included) against the JAX adapter in interpret mode."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from gnn_tpu.ops import pallas_spmm as jsm
    from gnn_tpu_torch.ops import sparse as tsp
    rng, rows, cols, vals = _coo(3, 384, 512, 0.02)
    b = tsp.pack_blocked(rows, cols, vals, 380, 500, 384, 512, max_blk=6)
    x = rng.randn(512, 72).astype(np.float32)
    got = tsm.blocked_spmm(torch.from_numpy(b.block_cols),
                           torch.from_numpy(b.block_vals),
                           torch.from_numpy(x), 128, 128).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsm.blocked_spmm_pallas(
            jnp.asarray(b.block_cols), jnp.asarray(b.block_vals),
            jnp.asarray(x), 128, 128))
    np.testing.assert_allclose(got, want, **TOL)
    dense = np.zeros((384, 512), np.float32)
    dense[rows, cols] = vals
    np.testing.assert_allclose(got, dense @ x, **TOL)


def test_other_devices_raise():
    """A tensor on neither the CPU nor a card takes no plain fallback."""
    from gnn_tpu_torch.ops import sddmm as tsd
    s = tsm.StreamBlocks(
        blk_rc=torch.zeros(8, dtype=torch.int32, device="meta"),
        vals=torch.zeros((8, 8, 128), device="meta"), nrows=8, ncols=128,
        bm=8, bk=128)
    with pytest.raises(ValueError, match="unsupported device"):
        tsm.stream_spmm(s, torch.zeros((128, 4), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tsd.stream_sddmm(s.blk_rc, torch.zeros((8, 4), device="meta"),
                         torch.zeros((128, 4), device="meta"), 8, 128)


def test_split_fills_the_card():
    """Runs split only where the blocks would not fill the card, never
    past the mean run length or MAX_SPLIT."""
    assert tsm.n_split(tsm.FILL_BLOCKS, 10_000, 16) == 1
    assert tsm.n_split(64, 1280, 16) == 5        # GAT tile layer, F 512
    assert tsm.n_split(16, 1280, 16) == tsm.MAX_SPLIT
    assert tsm.n_split(32, 40, 4) == 9
    assert tsm.n_split(32, 8, 4) == 2
    assert tsm.n_split(1, 0, 1) == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    return torch.device("cuda")


# nr, nc, f, density, bm, bk, rows populated below (None = all)
CUDA_CASES = [
    (256, 384, 96, 0.02, 128, 128, None),
    (384, 256, 602, 0.30, 128, 128, None),   # F not a multiple of 16
    (128, 256, 40, 0.05, 8, 128, 8),         # bm 8, empty row tiles
    (512, 512, 130, 0.01, 256, 64, None),    # 256-row tiles, 64-wide
    (4096, 256, 1100, 0.02, 128, 128, None),  # forward fills the card
]


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_kernel_matches_plain_version(cuda_device, case, transpose):
    """The CUDA kernel vs the plain version on the card. Tolerance:
    rtol = atol = 1e-4 — float32 sums of up to a few thousand products
    in another order."""
    nr, nc, f, dens, bm, bk, hi = case
    rng, rows, cols, vals = _coo(4, nr, nc, dens, hi)
    s = _to_torch(tsm.pack_stream(rows, cols, vals, nr, nc, bm=bm, bk=bk),
                  cuda_device)
    x = torch.from_numpy(rng.randn(nr if transpose else nc, f).astype(
        np.float32)).to(cuda_device)
    key = "transpose" if transpose else "forward"
    before = tsm.launches[key]
    got = tsm.stream_spmm(s, x, transpose)
    want = tsm.stream_spmm_ref(s, x, transpose)
    torch.cuda.synchronize()
    assert tsm.launches[key] == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_blocked_padding_tiles(cuda_device):
    """BlockedAdj padding (zero tiles at column tile 0, row tiles with
    fewer occupied tiles than max_blk) adds nothing and leaves no row
    unwritten, in both the forward and over the transposed blocks."""
    from gnn_tpu_torch.ops import sparse as tsp
    rng, rows, cols, vals = _coo(5, 384, 512, 0.01, 200)
    b = tsp.to_device(tsp.pack_blocked(rows, cols, vals, 200, 512, 384, 512,
                                       max_blk=7, max_blk_t=5), cuda_device)
    x = torch.from_numpy(rng.randn(512, 64).astype(np.float32)).to(
        cuda_device)
    g = torch.from_numpy(rng.randn(384, 64).astype(np.float32)).to(
        cuda_device)
    dense = tsp.to_dense(b)
    torch.testing.assert_close(
        tsm.blocked_spmm(b.block_cols, b.block_vals, x, 128, 128),
        dense @ x, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(
        tsm.blocked_spmm(b.block_cols_t, b.block_vals_t, g, 128, 128),
        dense.t() @ g, rtol=1e-4, atol=1e-4)
