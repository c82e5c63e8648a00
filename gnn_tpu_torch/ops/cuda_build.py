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


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built at first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _LIBS[name] = lib
        return lib
