"""The reduction from a profiled slice to numbers: the device's busy
time as the union of its kernel, memcpy and memset intervals (never the
sum of kernel times, which counts overlapping work twice), the device
time and calls of each kernel, the device operations that took most
time, and the longest idle gaps labelled by what the host was doing."""
from __future__ import annotations

import collections

import numpy as np

# idle gaps the host's label is looked up for, longest first
GAPS_LABELLED = 200
# entries of each breakdown list
TOP = 10


def union_seconds(starts, ends) -> float:
    """Total length of the union of intervals ``[starts[i], ends[i])``
    (nanoseconds in, seconds out)."""
    s = np.asarray(starts, np.int64)
    e = np.asarray(ends, np.int64)
    if s.size == 0:
        return 0.0
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    # running end of everything that started before each interval
    run_end = np.maximum.accumulate(e)
    # a new block starts where an interval begins after all before it
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > run_end[:-1]
    block = np.cumsum(new) - 1
    b_start = s[new]
    b_end = np.zeros(b_start.size, np.int64)
    np.maximum.at(b_end, block, e)
    return float((b_end - b_start).sum()) / 1e9


def idle_gaps(starts, ends, t0: int, t1: int):
    """``(gap_starts, gap_ends)`` of ``[t0, t1)`` (ns) where no interval
    runs."""
    s = np.asarray(starts, np.int64)
    e = np.asarray(ends, np.int64)
    if s.size == 0:
        return np.array([t0]), np.array([t1])
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    run_end = np.maximum.accumulate(e)
    # before the first interval, between each start and the running end
    # of everything before it, and after the last
    g_start = np.concatenate([[t0], run_end[:-1], [run_end[-1]]])
    g_end = np.concatenate([[s[0]], s[1:], [t1]])
    keep = g_end > g_start
    return g_start[keep], g_end[keep]


def _short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def kernel_totals(events) -> tuple:
    """``({name: seconds}, {name: calls})`` over device events
    ``(name, start_ns, end_ns)``."""
    secs = collections.Counter()
    calls = collections.Counter()
    for name, s, e in events:
        secs[name] += (e - s) / 1e9
        calls[name] += 1
    return dict(secs), dict(calls)


def reduce_slice(device_events, host_events, t0: int, t1: int) -> dict:
    """Numbers of one profiled slice ``[t0, t1)`` (ns, the profiler's
    clock). ``device_events``: ``(name, start, end)`` of every kernel,
    memcpy and memset; ``host_events``: ``(name, start, end)`` of the
    main thread's ops and spans."""
    dev = [(n, max(s, t0), min(e, t1)) for n, s, e in device_events
           if e > t0 and s < t1]
    starts = [s for _, s, _ in dev]
    ends = [e for _, _, e in dev]
    busy = union_seconds(starts, ends)
    secs, calls = kernel_totals(dev)
    top_ops = sorted(secs.items(), key=lambda kv: -kv[1])[:TOP]
    g_s, g_e = idle_gaps(starts, ends, t0, t1)
    longest = np.argsort(-(g_e - g_s), kind="stable")[:GAPS_LABELLED]
    if host_events:
        h_name = [n for n, _, _ in host_events]
        h_s = np.array([s for _, s, _ in host_events], np.int64)
        h_e = np.array([e for _, _, e in host_events], np.int64)
    by_label = collections.Counter()
    for i in longest:
        mid = (g_s[i] + g_e[i]) // 2
        label = "host: no recorded op"
        if host_events:
            cover = np.flatnonzero((h_s <= mid) & (h_e >= mid))
            if cover.size:
                # the innermost op: the latest to start
                label = h_name[cover[np.argmax(h_s[cover])]]
        by_label[label] += (g_e[i] - g_s[i]) / 1e9
    gaps = sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy, "window_s": (t1 - t0) / 1e9,
            "kernel_s": secs, "kernel_calls": calls,
            "device_ops": [[_short(n), v] for n, v in top_ops],
            "idle_gaps": [[_short(n), v] for n, v in gaps]}


def profile_events(prof, span: str):
    """``(device_events, host_events, (t0, t1))`` of a stopped
    ``torch.profiler.profile``: every kernel, memcpy and memset, the ops
    and spans of the thread that opened the span named ``span``, and
    that span's interval. A span's shadow on the device's timeline
    (kineto's ``gpu_user_annotation``, named as the host span) is no
    operation and is left out."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s, e = ev.start_ns(), ev.end_ns()
        if ev.device_type() == cuda:
            dev.append((ev.name(), s, e))
        else:
            host.append((ev.name(), s, e, ev.start_thread_id()))
    host_names = {h[0] for h in host}
    dev = [d for d in dev if d[0] not in host_names]
    mine = [h for h in host if h[0] == span]
    if not mine:
        raise RuntimeError(f"the profile holds no span {span!r}")
    _, t0, t1, tid = mine[0]
    return dev, [(n, s, e) for n, s, e, t in host if t == tid], (t0, t1)


def sum_matching(kernel_s: dict, kernel_calls: dict, include: str,
                 exclude: tuple = ()) -> tuple:
    """``(seconds, calls)`` of the kernels whose name holds ``include``
    and none of ``exclude``."""
    secs = calls = 0
    for name, v in kernel_s.items():
        if include in name and not any(x in name for x in exclude):
            secs += v
            calls += kernel_calls[name]
    return secs, calls
