"""The stream SDDMM (K5) of the PyTorch port (gnn_tpu_torch.ops.sddmm)
against the JAX package's (gnn_tpu.ops.pallas_sddmm).

* The plain version must match the Pallas kernel run in interpret mode
  and the JAX ``sddmm_reference`` on the same stream and inputs, and
  ``masked_edge_scores`` the JAX one. Tolerance: rtol = atol = 1e-5 —
  the same float32 products, summed in another order.
* On a machine with a card, the CUDA kernel must match the plain version
  (``-m cuda``; JAX is imported only inside the parity tests).
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gnn_tpu_torch.ops import sddmm as tsd
from gnn_tpu_torch.ops import spmm as tsm

TOL = dict(rtol=1e-5, atol=1e-5)


def _stream(seed, R, C, dens, bm, bk):
    rng = np.random.RandomState(seed)
    m = sp.random(R, C, density=dens, format="coo", random_state=rng,
                  dtype=np.float32)
    return rng, tsm.pack_stream(m.row, m.col, m.data + 0.5, R, C, bm=bm,
                                bk=bk)


@pytest.mark.parametrize("R,C,F,dens,bm", [(256, 384, 64, 0.05, 128),
                                           (64, 256, 20, 0.1, 8)])
def test_plain_version_matches_pallas_interpret(R, C, F, dens, bm):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from gnn_tpu.ops import pallas_sddmm as jsd
    rng, s = _stream(0, R, C, dens, bm, 128)
    x = rng.randn(R, F).astype(np.float32)
    y = rng.randn(C, F).astype(np.float32)
    got = tsd.stream_sddmm(torch.from_numpy(s.blk_rc), torch.from_numpy(x),
                           torch.from_numpy(y), bm, 128).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsd.stream_sddmm(jnp.asarray(s.blk_rc),
                                           jnp.asarray(x), jnp.asarray(y),
                                           bm, 128))
    np.testing.assert_allclose(got, want, **TOL)
    ref = np.asarray(jsd.sddmm_reference(jnp.asarray(s.blk_rc),
                                         jnp.asarray(x), jnp.asarray(y), bm,
                                         128))
    np.testing.assert_allclose(got, ref, **TOL)


def test_masked_edge_scores_match_jax():
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from gnn_tpu.ops import pallas_sddmm as jsd
    from gnn_tpu.ops import pallas_spmm as jsm
    rng, s = _stream(1, 128, 256, 0.08, 128, 128)
    x = rng.randn(128, 32).astype(np.float32)
    y = rng.randn(256, 32).astype(np.float32)
    ts = tsm.StreamBlocks(blk_rc=torch.from_numpy(s.blk_rc),
                          vals=torch.from_numpy(s.vals), nrows=s.nrows,
                          ncols=s.ncols, bm=s.bm, bk=s.bk)
    got = tsd.masked_edge_scores(ts, torch.from_numpy(x),
                                 torch.from_numpy(y))
    js = jax.tree_util.tree_map(jnp.asarray, jsm.StreamBlocks(
        blk_rc=s.blk_rc, vals=s.vals, nrows=s.nrows, ncols=s.ncols,
        bm=s.bm, bk=s.bk))
    with pltpu.force_tpu_interpret_mode():
        want = jsd.masked_edge_scores(js, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(got.vals.numpy(), np.asarray(want.vals),
                               **TOL)
    assert torch.equal(got.blk_rc, ts.blk_rc)
    assert (got.nrows, got.ncols, got.bm, got.bk) == \
        (want.nrows, want.ncols, want.bm, want.bk)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,F,bm,bk", [(256, 384, 512, 128, 128),
                                         (512, 256, 100, 256, 64),
                                         (64, 256, 7, 8, 128)])
def test_cuda_kernel_matches_plain_version(cuda_device, R, C, F, bm, bk):
    """The CUDA kernel vs the plain version on the card. Tolerance:
    rtol = atol = 1e-4 — float32 sums of F products in another order."""
    rng, s = _stream(2, R, C, 0.05, bm, bk)
    blk_rc = torch.from_numpy(s.blk_rc).to(cuda_device)
    x = torch.from_numpy(rng.randn(R, F).astype(np.float32)).to(cuda_device)
    y = torch.from_numpy(rng.randn(C, F).astype(np.float32)).to(cuda_device)
    before = tsd.launches["sddmm"]
    got = tsd.stream_sddmm(blk_rc, x, y, bm, bk)
    want = tsd.sddmm_reference(blk_rc, x, y, bm, bk)
    torch.cuda.synchronize()
    assert tsd.launches["sddmm"] == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
