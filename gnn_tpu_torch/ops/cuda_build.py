"""Build and load the port's hand-written CUDA kernels.

Each kernel source ``gnn_tpu_torch/csrc/<name>.cu`` exposes a plain C
interface. At first use it is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``gnn_tpu_torch/_build/<name>-<content hash>.so``
(the directory is git-ignored) and loaded with ``ctypes``. The build is
keyed by the source's content, written to a temporary file and renamed
into place, so concurrent processes never load a half-written library.
A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from gnn_tpu_torch.utils.timing import span, spanned

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: dict = {}
# seconds each library's build took in this process (0.0 = loaded from
# an existing build)
BUILD_SECONDS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
                       "kernels are built from gnn_tpu_torch/csrc at "
                       "first use on a machine with the CUDA toolkit")


def library_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()
                           ).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"{name}-{tag}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its content-keyed library
    exists; returns the library path."""
    so_path = library_path(name)
    if os.path.exists(so_path):
        BUILD_SECONDS.setdefault(name, 0.0)
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return so_path


@spanned("setup.kernels")
def build_all() -> list:
    """Compile every ``csrc/*.cu`` that is not built yet, one nvcc each,
    all started together (a span ``setup.kernels``); returns the
    sources' names."""
    from concurrent.futures import ThreadPoolExecutor
    names = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
    with ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(build, names))
    return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built at first use; the
    first load is a span ``setup.kernels``)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            with span("setup.kernels"):
                lib = ctypes.CDLL(build(name))
            _LIBS[name] = lib
        return lib


# the modules of gnn_tpu_torch.ops whose wrappers count their kernels'
# launches (each a ``launches`` Counter and a ``captured`` one, through
# :func:`count_launch`)
KERNEL_MODULES = ("edgestream", "esattn", "hotattn", "spmm", "sddmm")


def count_launch(launches, captured, key: str) -> None:
    """Count one kernel launch under ``key``: in ``captured`` when the
    current stream is capturing a CUDA graph (the launch then runs at
    each replay of the graph; `gnn_tpu_torch.train.dispatch`
    multiplies), else in ``launches``."""
    import torch
    if torch.cuda.is_current_stream_capturing():
        captured[key] += 1
    else:
        launches[key] += 1


def launch_counts(kind: str = "launches") -> dict:
    """Every kernel wrapper's launches so far in this process
    (``kind="launches"``), or those recorded into CUDA graphs
    (``"captured"``), by ``module.key``."""
    import importlib
    out = {}
    for mod in KERNEL_MODULES:
        c = getattr(importlib.import_module(f"gnn_tpu_torch.ops.{mod}"),
                    kind)
        out.update({f"{mod}.{k}": v for k, v in c.items()})
    return out
