"""(A copy of `gnn_tpu.data.shared`, so the port imports nothing of the
JAX package; its segments are named ``gnn_tpu_torch_*``.) Zero-copy
shared-memory CSR for multi-process host sampling.

The reference sketches (but never uses) a multiprocessing variant that
shares the CSR arrays across sampler processes
(the reference's `preprocess.py:427-446`, ``mp.Array``). Here it is a
working implementation on ``multiprocessing.shared_memory``: the graph is
published once, worker processes attach without copying, and the ~GB-scale
laplacian never crosses a pipe. Use when thread-level parallelism (the
default pipeline) is GIL-bound — the native sampler core releases the GIL,
so threads usually suffice; processes are the escape hatch for pure-numpy
fallback environments.
"""
from __future__ import annotations

import dataclasses
import os
import uuid
from multiprocessing import shared_memory
from typing import List, Tuple

import numpy as np
import scipy.sparse as sp


PREFIX = "gnn_tpu_torch"


def _new_segment(nbytes: int, prefix: str = PREFIX):
    """A new shared-memory segment named ``{prefix}_{pid}_{random}``."""
    return shared_memory.SharedMemory(
        name=f"{prefix}_{os.getpid()}_{uuid.uuid4().hex[:16]}",
        create=True, size=max(nbytes, 1))


@dataclasses.dataclass
class SharedCSRHandle:
    """Picklable descriptor of a CSR published in shared memory."""

    names: Tuple[str, str, str]
    dtypes: Tuple[str, str, str]
    lens: Tuple[int, int, int]
    shape: Tuple[int, int]


class SharedCSR:
    """Owner-side wrapper; call ``close()`` (or use as context manager)
    to release the segments."""

    def __init__(self, csr: sp.csr_matrix, prefix: str = PREFIX):
        self._segs: List[shared_memory.SharedMemory] = []
        arrays = (np.ascontiguousarray(csr.indptr),
                  np.ascontiguousarray(csr.indices),
                  np.ascontiguousarray(csr.data))
        names = []
        for i, a in enumerate(arrays):
            seg = _new_segment(a.nbytes, prefix)
            np.ndarray(a.shape, a.dtype, buffer=seg.buf)[:] = a
            self._segs.append(seg)
            names.append(seg.name)
        self.handle = SharedCSRHandle(
            names=tuple(names),
            dtypes=tuple(str(a.dtype) for a in arrays),
            lens=tuple(len(a) for a in arrays),
            shape=tuple(csr.shape))

    def close(self):
        for seg in self._segs:
            seg.close()
            try:
                seg.unlink()
            except FileNotFoundError:
                pass
        self._segs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def attach_shared_csr(handle: SharedCSRHandle):
    """Worker-side: attach and reconstruct the CSR (no copy).

    Returns (csr_matrix, segments) — keep ``segments`` alive while the
    matrix is in use.
    """
    segs = [shared_memory.SharedMemory(name=n) for n in handle.names]
    arrays = [np.ndarray((l,), np.dtype(d), buffer=s.buf)
              for s, d, l in zip(segs, handle.dtypes, handle.lens)]
    csr = sp.csr_matrix((arrays[2], arrays[1], arrays[0]),
                        shape=handle.shape)
    return csr, segs


@dataclasses.dataclass
class SharedArrayHandle:
    """Picklable descriptor of a dense ndarray published in shared
    memory (feature tables, resident dense blocks, node-id vectors)."""

    name: str
    dtype: str
    shape: Tuple[int, ...]


class SharedArray:
    """Owner-side dense-array counterpart of :class:`SharedCSR`."""

    def __init__(self, a: np.ndarray):
        a = np.ascontiguousarray(a)
        self._seg = _new_segment(a.nbytes)
        np.ndarray(a.shape, a.dtype, buffer=self._seg.buf)[:] = a
        self.handle = SharedArrayHandle(name=self._seg.name,
                                        dtype=str(a.dtype),
                                        shape=tuple(a.shape))

    def close(self):
        if self._seg is not None:
            self._seg.close()
            try:
                self._seg.unlink()
            except FileNotFoundError:
                pass
            self._seg = None


def attach_shared_array(handle: SharedArrayHandle):
    """Worker-side: zero-copy ndarray view; keep the returned segment
    alive while the array is in use."""
    seg = shared_memory.SharedMemory(name=handle.name)
    a = np.ndarray(handle.shape, np.dtype(handle.dtype), buffer=seg.buf)
    return a, seg


class GraphBundle:
    """Publish a dict of graph-scale host state (ndarrays and CSR
    matrices) in shared memory ONCE per host, so sibling controller
    processes attach instead of rebuilding — the multiprocess variant
    the reference sketched and abandoned (`preprocess.py:427-446`),
    completed. Typical contents: the normalized laplacian, the feature
    table, the labels CSR, train-node ids, and the resident hot blocks
    (`dense`/`dense_t`) + slot table.

    Owner: ``GraphBundle.publish(items, path)`` — writes a picklable
    handle file ATOMICALLY (rename), so workers can poll for it.
    Worker: ``GraphBundle.attach(path)`` returns ``(items, keepalive)``
    with zero-copy arrays/CSRs; hold ``keepalive`` while in use.
    """

    def __init__(self, owners, path):
        self._owners = owners
        self._path = path

    @staticmethod
    def publish(items: dict, path: str) -> "GraphBundle":
        import pickle

        owners = {}
        handles = {}
        for k, v in items.items():
            if sp.issparse(v):
                o = SharedCSR(v.tocsr())
                handles[k] = ("csr", o.handle)
            elif isinstance(v, np.ndarray):
                o = SharedArray(v)
                handles[k] = ("arr", o.handle)
            else:
                # small metadata (ints/flags) rides in the handle file
                handles[k] = ("meta", v)
                continue
            owners[k] = o
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(handles, f)
        os.replace(tmp, path)
        return GraphBundle(owners, path)

    @staticmethod
    def attach(path: str, timeout: float = 120.0):
        import pickle
        import time

        deadline = time.monotonic() + timeout
        while not os.path.exists(path):
            if time.monotonic() > deadline:
                raise TimeoutError(f"graph bundle {path} never appeared")
            time.sleep(0.05)
        with open(path, "rb") as f:
            handles = pickle.load(f)
        items = {}
        keepalive = []
        for k, (kind, h) in handles.items():
            if kind == "csr":
                m, segs = attach_shared_csr(h)
                items[k] = m
                keepalive.extend(segs)
            elif kind == "meta":
                items[k] = h
            else:
                a, seg = attach_shared_array(h)
                items[k] = a
                keepalive.append(seg)
        return items, keepalive

    def close(self):
        for o in self._owners.values():
            o.close()
        self._owners = {}
        try:
            os.unlink(self._path)
        except FileNotFoundError:
            pass
