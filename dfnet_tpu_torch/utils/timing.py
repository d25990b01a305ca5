"""Kernel timing on the card with CUDA events."""

from __future__ import annotations

import statistics

import torch


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of fn() over `reps` runs, timed with CUDA events
    on the current stream after `warmup` untimed runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)
