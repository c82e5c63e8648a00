"""The port's entry points (gnn_tpu_torch.entry) against the JAX
package's ``__graft_entry__.py``.

``entry`` builds the same tiny batch and, with the flax weights carried
across (`gnn_tpu_torch.weights.params_from_flax`), gives the JAX
forward's logits within 1e-5 (float32 sums in another order).
``dryrun_multichip`` runs every case of the JAX dry run on 2 and 4 gloo
ranks on the CPU. This module imports JAX only inside its tests, so
``pytest --noconftest -m cuda`` runs its card test where JAX is absent.
"""
import math

import numpy as np
import pytest
import torch

from gnn_tpu_torch import entry as tentry
from gnn_tpu_torch.parallel import dist as tdist

FLAT_CASES = ["dp_cache_hot", "resident", "resident_stream",
              "gat_hot_block", "gat_stream"]
GRID_CASES = ["sharded_resident", "full_expansion", "composed",
              "hybrid_cache"]


def _entries_agree():
    """The JAX entry and the port's on the CPU: the same batch, and the
    same logits within 1e-5 from the flax weights carried across."""
    import __graft_entry__ as jentry
    import jax

    from gnn_tpu_torch.weights import params_from_flax
    jfn, (jparams, jx, jadjs, jsampled) = jentry.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jx, jadjs, jsampled))
    fn, (params, x, adjs, sampled) = tentry.entry("cpu")
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    for s, js in zip(sampled, jsampled):
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    carried = params_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    assert carried.keys() == params.keys()
    got = fn(carried, x, adjs, sampled).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the port's own weights: a forward of the same shape, eval mode
    # (no dropout: two calls agree bit for bit)
    a, b = fn(params, x, adjs, sampled), fn(params, x, adjs, sampled)
    assert a.shape == want.shape and torch.equal(a, b)


def test_entry_matches_the_jax_forward():
    """Both entries sample outside a pipeline, so both native samplers
    are pinned to one width first (an earlier test in this process may
    have left either at any width)."""
    from torch_sampler_width import same_sampler_width
    same_sampler_width()
    _entries_agree()


def test_entry_agrees_after_the_widths_diverge():
    """Each library set to a different width, as a pipeline built by an
    earlier test leaves it; the pinned helper brings them to one width
    and the entries agree again."""
    from gnn_tpu import native as jnative
    from gnn_tpu_torch import native as tnative
    from torch_sampler_width import same_sampler_width
    jlib, tlib = jnative.get_lib(), tnative.get_lib()
    if jlib is None or tlib is None:
        pytest.skip("a native sampler library does not load")
    jlib.set_threads(1)
    tlib.set_threads(3)
    same_sampler_width()
    _entries_agree()


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_the_cpu(tmp_path, capsys, n):
    """Every case's loss finite on every rank (the same on every rank:
    each step's loss is the mean over the ranks); on 4 ranks the 2 x 2
    grid's cases too, each rank's resident bytes 1/P of the whole state
    within the padding, and the halo trainer over the grid."""
    saved = tdist.JOIN_TIMEOUT_S, tdist.COLLECTIVE_TIMEOUT_S
    tdist.JOIN_TIMEOUT_S, tdist.COLLECTIVE_TIMEOUT_S = 300.0, 120.0
    try:
        out = tentry.dryrun_multichip(n, "cpu", run_dir=str(tmp_path))
    finally:
        tdist.JOIN_TIMEOUT_S, tdist.COLLECTIVE_TIMEOUT_S = saved
    want = FLAT_CASES + (GRID_CASES if n == 4 else []) + ["halo"]
    assert list(out) == want
    for name, res in out.items():
        assert len(res["losses"]) == n
        assert all(math.isfinite(v) for v in res["losses"]), name
        assert len(set(res["losses"])) == 1, name
        assert res["steps"] == 1
    assert out["halo"]["grid"] == ("2x2" if n == 4 else None)
    if n == 4:
        r = out["sharded_resident"]
        assert r["parts"] == 2
        assert all(b <= r["full_bytes"] / 2 * tentry.RESIDENT_SLACK
                   for b in r["resident_bytes"])
    lines = capsys.readouterr().out.splitlines()
    assert any("multi-step scan" in ln and "not ported" in ln
               for ln in lines)
    assert sum(f"dryrun_multichip({n}) " in ln and " OK: " in ln
               for ln in lines) == len(want)


def test_entry_points_refuse_a_missing_card():
    """Without a card, the entry points raise; nothing drops to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        tentry.dryrun_multichip(2)


@pytest.mark.cuda
def test_cuda_entry_and_dryrun(tmp_path):
    """On the card: the forward on ``cuda`` equals the CPU's within 1e-5,
    and the dry run on two ranks sharing ``cuda:0`` launches K1 in the
    stream-tile case and K3 / K4 in GAT's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    fn, args = tentry.entry("cpu")
    cfn, cargs = tentry.entry("cuda")
    np.testing.assert_allclose(cfn(*cargs).cpu().numpy(),
                               fn(*args).detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    out = tentry.dryrun_multichip(2, "cuda", run_dir=str(tmp_path))
    assert out["resident_stream"]["launches"].get("edgestream.forward")
    for k in ("rowmax", "terms", "bwd_q", "bwd_kv"):
        assert out["gat_stream"]["launches"].get(f"esattn.{k}"), k
