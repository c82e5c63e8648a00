"""What the harness and the reference load: no module whose top-level
name is ``jax``, ``jaxlib``, ``flax`` or ``gnn_tpu`` (compared whole:
``gnn_tpu_torch`` begins with ``gnn_tpu``), and the reference nothing of
``gnn_tpu_torch`` either."""
import os
import subprocess
import sys

import portbench_tiny

PROBE = r"""
import sys
sys.path.insert(0, {root!r})
{body}
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(" ".join(tops))
"""


def _env() -> dict:
    """A bare environment (no ``PYTHONPATH`` or site hooks that could
    load a package), with the caller's ``HOME`` and ``TMPDIR`` and the
    native sampler's build in the checkout's cache, where a run puts
    it."""
    env = {"PATH": "/usr/bin:/bin",
           "GNN_TPU_TORCH_NATIVE_CACHE": os.path.join(
               portbench_tiny.ROOT, "portbench", ".cache", "native")}
    for var in ("HOME", "TMPDIR"):
        if var in os.environ:
            env[var] = os.environ[var]
    return env


def _tops(body: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=portbench_tiny.ROOT,
                                             body=body)],
        capture_output=True, text=True, timeout=600, env=_env())
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split()[-1000:])


def test_reference_loads_nothing_of_either_package():
    tops = _tops("import portbench.reference.train, "
                 "portbench.reference.model_graphsage, "
                 "portbench.reference.model_gat, portbench.check, "
                 "portbench.counts.step, portbench.counts.model_graphsage, "
                 "portbench.counts.model_gat, portbench.trace")
    assert not tops & {"jax", "jaxlib", "flax", "gnn_tpu", "gnn_tpu_torch"}


def test_a_tiny_run_loads_no_jax_package():
    body = """
import os
os.environ["GNN_TPU_TORCH_SYNTH_CACHE"] = ""
from portbench import harness
import portbench_tiny
cell, cfg, tr = portbench_tiny.tiny("sage-reddit-g8")
from portbench import check
lim = {k: 1.0 for k in check.NUMBERS}
r = harness.run_cell(cell, cfg, tr, 5, 0.5, False, lim, device="cpu",
                     require_card=False, metric_names=[])
assert r["correct"], r
assert not harness.forbidden_modules()
"""
    tops = _tops("sys.path.insert(0, %r)\n" % (
        portbench_tiny.ROOT + "/portbench/tests") + body)
    assert "gnn_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "gnn_tpu"}


def test_forbidden_names_compare_whole(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, "gnn_tpu_torchx", sys)
    assert "gnn_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gnn_tpu.data", sys)
    assert "gnn_tpu" in harness.forbidden_modules()
