"""Kernel timing on the card by CUDA events (used by ``chip_smoke.py`` and
the measurement tools under ``tools/``)."""
from __future__ import annotations

import torch


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
