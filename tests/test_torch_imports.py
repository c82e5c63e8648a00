"""The PyTorch port, ``chip_smoke.py`` and the port's tools
(``tools/torch_*.py``) import no JAX and nothing of the JAX package.

The import check runs in a subprocess: this test session has already
imported jax (tests/conftest.py)."""
import os
import pkgutil
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "gnn_tpu_torch")


def _modules():
    import gnn_tpu_torch
    names = ["gnn_tpu_torch"]
    for m in pkgutil.walk_packages(gnn_tpu_torch.__path__,
                                   prefix="gnn_tpu_torch."):
        names.append(m.name)
    return names


def test_importing_every_module_loads_no_jax():
    names = _modules()
    assert "gnn_tpu_torch.ops.edgestream" in names
    assert "gnn_tpu_torch.ops.esattn" in names
    assert "gnn_tpu_torch.models.gat" in names
    assert "gnn_tpu_torch.cli" in names
    assert "gnn_tpu_torch.ops.hotdense" in names
    assert "gnn_tpu_torch.utils.timing" in names
    for m in ("entry", "parallel.halo", "train.fullgraph", "data.reorder",
              "data.shared", "train.dispatch"):
        assert f"gnn_tpu_torch.{m}" in names, m
    code = ("import importlib, sys\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'gnn_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_never_import_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(gnn_tpu|jax|flax|optax)\b"
                     r"(?!_torch)", re.M)
    hits = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    for m in pat.finditer(fh.read()):
                        hits.append(f"{path}: {m.group(0).strip()}")
    scripts = ["chip_smoke.py"] + sorted(
        os.path.join("tools", f) for f in os.listdir(os.path.join(ROOT,
                                                                  "tools"))
        if f.startswith("torch_") and f.endswith(".py"))
    assert os.path.join("tools", "torch_edgestream_probe.py") in scripts
    for rel in scripts:
        with open(os.path.join(ROOT, rel)) as fh:
            for m in pat.finditer(fh.read()):
                hits.append(f"{rel}: {m.group(0).strip()}")
    assert not hits, hits
