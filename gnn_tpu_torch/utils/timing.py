"""Timing: the port's span-and-counter recorder, and kernel timing on the
card by CUDA events (used by ``chip_smoke.py`` and the measurement tools
under ``tools/``).

The recorder (:data:`RECORDER`, one a process, as
`gnn_tpu_torch.ops.cuda_build.launch_counts` is) names the host's
intervals where the work happens. ``with span(name):`` takes two
``time.perf_counter_ns()`` reads and adds, to a total keyed by (epoch,
name), the duration, the self time (the duration less what the span's
children on the same thread cover) and one call, and records the name of
its parent span. ``count(name, n)`` adds ``n`` to a counter under the
same key. The epoch is the one `Trainer.train_epoch` set last
(:attr:`Recorder.epoch`); before any, ``"setup"``. A span on a sampler
worker adds to the epoch current when it ends. While a
``torch.profiler`` records, a span also opens
``torch.profiler.record_function(name)``, so the profiler's trace holds
the span on the clock of its kernel, memcpy and memset events; otherwise
nothing reaches the profiler.

A span is no place inside a CUDA-graph capture: it runs once, at the
capture, and never at a replay.
"""
from __future__ import annotations

import functools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

# the epoch key of work done before any epoch
SETUP = "setup"


if hasattr(_profiler, "_is_profiler_enabled"):
    def _profiling() -> bool:
        """Whether a ``torch.profiler`` records (on any thread)."""
        return _profiler._is_profiler_enabled
else:
    # older releases: the calling thread's profiler state
    _profiling = torch.autograd._profiler_enabled


class Span:
    """One timed interval: ``name``, its ``parent``'s name (None at the
    top of a thread), its clock reads ``t0`` / ``t1`` (ns) and the ns its
    children cover. Enter it once."""

    __slots__ = ("name", "parent", "t0", "t1", "child_ns", "_rec", "_rf",
                 "_stack")

    def __init__(self, rec: "Recorder", name: str):
        self.name = name
        self._rec = rec
        self.parent = None
        self.t0 = self.t1 = self.child_ns = 0
        self._rf = None

    @property
    def ns(self) -> int:
        return self.t1 - self.t0

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def __enter__(self) -> "Span":
        local = self._rec._local
        try:
            stack = local.stack
        except AttributeError:
            stack = local.stack = []
        if stack:
            self.parent = stack[-1].name
        stack.append(self)
        self._stack = stack
        if _profiling():
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        stack = self._stack
        stack.pop()
        dur = t1 - self.t0
        if stack:
            stack[-1].child_ns += dur
        self._rec._add_span(self.name, dur, dur - self.child_ns,
                            self.parent)


class Recorder:
    """Span and counter totals by (epoch, name), thread-safe (one lock).
    A span total is ``[ns, self ns, calls, {parent names}]``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.epoch = SETUP
        self._spans = {}
        self._counts = {}

    def span(self, name: str) -> Span:
        return Span(self, name)

    def _add_span(self, name, ns, self_ns, parent) -> None:
        with self._lock:
            key = (self.epoch, name)
            tot = self._spans.get(key)
            if tot is None:
                tot = self._spans[key] = [0, 0, 0, set()]
            tot[0] += ns
            tot[1] += self_ns
            tot[2] += 1
            tot[3].add(parent)

    def count(self, name: str, n=1) -> None:
        with self._lock:
            key = (self.epoch, name)
            self._counts[key] = self._counts.get(key, 0) + n

    def reset(self) -> None:
        """Forget every total and go back to the ``"setup"`` epoch."""
        with self._lock:
            self._spans.clear()
            self._counts.clear()
            self.epoch = SETUP

    def epochs(self) -> list:
        """Every epoch key that holds a total."""
        with self._lock:
            keys = {k for k, _ in self._spans} | {k for k, _ in
                                                   self._counts}
        return sorted(keys, key=str)

    def totals(self, epoch) -> dict:
        """One epoch's totals as ``metrics.jsonl`` logs them: ``spans``
        (by name: ``s``, ``self_s``, ``calls``, ``parents``) and
        ``counts`` (by name)."""
        with self._lock:
            spans = {n: {"s": t[0] / 1e9, "self_s": t[1] / 1e9,
                         "calls": t[2],
                         "parents": sorted(p for p in t[3] if p)}
                     for (e, n), t in self._spans.items() if e == epoch}
            counts = {n: v for (e, n), v in self._counts.items()
                      if e == epoch}
        return {"spans": spans, "counts": counts}

    def total(self, name: str, epochs, what: str = "s"):
        """A span's ``s`` (seconds), ``self_s`` or ``calls``, or a
        counter's value (``what="count"``), summed over ``epochs``; None
        where nothing was recorded there."""
        epochs = set(epochs)
        with self._lock:
            if what == "count":
                vals = [v for (e, n), v in self._counts.items()
                        if n == name and e in epochs]
                return sum(vals) if vals else None
            i = {"s": 0, "self_s": 1, "calls": 2}[what]
            vals = [t[i] for (e, n), t in self._spans.items()
                    if n == name and e in epochs]
        if not vals:
            return None
        return sum(vals) if what == "calls" else sum(vals) / 1e9


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count


def spanned(name: str):
    """Decorator: every call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return timed
    return wrap


def cuda_time_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time in ms of ``reps``
    back-to-back calls of ``fn``, by CUDA events, after three warm-up
    calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        per.append(a.elapsed_time(b) / reps)
    per.sort()
    return per[len(per) // 2]
