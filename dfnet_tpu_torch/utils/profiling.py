"""Tracing hooks (port of dfnet_tpu/utils/profiling.py): a torch.profiler
trace context that writes a Chrome trace (chrome://tracing, Perfetto), and
the program's named phase regions that show in it.

The render view, the stage-1 step and the stage-3 step each open one root
region (`dfnet.render.view`, `dfnet.train.step`, `dfnet.dm.step`) and a
region per phase inside it (`dfnet.render.sample`, `dfnet.train.backward`,
...). They are torch.profiler user annotations, so they share the trace's
clock with the kernels, copies and runtime calls: an idle gap of the device
lies inside the phase that left it idle. With no trace running a region
costs one read of the profiler's flag.
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp
import time
from typing import Optional

import torch

_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """Trace the block with torch.profiler (the host, and the GPU's kernels
    when there is one) and write it as a Chrome trace,
    <logdir>/trace_<pid>_<ns>.json, when the block ends. A no-op for a
    None or empty logdir."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(osp.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named region of the trace: torch.profiler.record_function(name)
    while a profiler is recording, else one shared no-op context. Calls no
    torch op and never waits for the device."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
