"""Tracing and profiling hooks (port of dfnet_tpu/utils/profiling.py): a
step timer with EMA and percentile summaries, a torch.profiler trace
context that writes a Chrome trace (chrome://tracing, Perfetto), and named
regions that show in it."""

from __future__ import annotations

import contextlib
import os
import os.path as osp
import time
from collections import deque
from typing import Deque, Dict, Optional

import numpy as np


class StepTimer:
    """Wall-clock step timer with exponential moving average and
    percentile reporting. Time on the host's clock: a GPU step must end in
    a sync (a read of its loss) inside the timed region.

    Usage:
        timer = StepTimer()
        with timer.step():
            ... one training step ...
        print(timer.summary())
    """

    def __init__(self, window: int = 200, ema_alpha: float = 0.05):
        self.samples: Deque[float] = deque(maxlen=window)
        self.ema: Optional[float] = None
        self.alpha = ema_alpha
        self.count = 0

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.add(time.perf_counter() - t0)

    def add(self, dt: float):
        self.samples.append(dt)
        self.ema = dt if self.ema is None else (1 - self.alpha) * self.ema + self.alpha * dt
        self.count += 1

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        arr = np.asarray(self.samples)
        return {
            "steps": self.count,
            "mean_ms": float(arr.mean() * 1e3),
            "ema_ms": float((self.ema or 0.0) * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
            "steps_per_sec": float(1.0 / arr.mean()),
        }


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """Trace the block with torch.profiler (the host, and the GPU's kernels
    when there is one) and write it as a Chrome trace,
    <logdir>/trace_<pid>_<ns>.json, when the block ends. A no-op for a
    None or empty logdir."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(osp.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region, visible in device_trace's trace."""
    import torch

    with torch.profiler.record_function(name):
        yield
