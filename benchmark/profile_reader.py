"""The traced window, read from torch.profiler's device trace: when the
device was busy, each kernel's device time by name, the longest idle gaps
and what the host was doing in each.

Events come from the profiler's kineto results: device-side events
(kernels, copies, sets) are those whose device type is not the CPU; host
events are the CPU ops and CUDA runtime calls, and the benchmark's own
spans (torch.profiler.record_function).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


# the profiler's own host events, not the program's work
PROFILER_OWN = ("Activity Buffer",)


@dataclass
class Trace:
    window_s: float                                     # host clock, traced window
    device: List[Tuple[str, int, int]] = field(default_factory=list)   # name, start, end (ns)
    host: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the device events' intervals)."""
        return sum(e - s for s, e in self.merged()) / 1e9

    def merged(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def kernel(self, patterns: Sequence[str]) -> Tuple[int, float]:
        """(events, device seconds) of the device events whose name holds
        any of the patterns."""
        hits = [e - s for n, s, e in self.device if any(p in n for p in patterns)]
        return len(hits), sum(hits) / 1e9

    def top_ops(self, k: int = 10) -> List[List]:
        """The k device operations with the most device time: [name, s]."""
        by: Dict[str, float] = {}
        for n, s, e in self.device:
            key = n[:120]
            by[key] = by.get(key, 0.0) + (e - s) / 1e9
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The k longest gaps between device work: [what the host was
        doing at the gap's middle (its innermost event), s]."""
        merged = self.merged()
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                       for i in range(len(merged) - 1)), reverse=True)[:k]
        host = sorted(self.host, key=lambda x: x[1])
        starts = [h[1] for h in host]
        out = []
        for length, s, e in gaps:
            mid = (s + e) // 2
            j = bisect.bisect_right(starts, mid)
            inner: Optional[Tuple[str, int, int]] = None
            for n, hs, he in reversed(host[max(0, j - 4000):j]):
                if he >= mid and (inner is None or he - hs < inner[2] - inner[1]):
                    inner = (n, hs, he)
            out.append([inner[0][:120] if inner else "host between ops", length / 1e9])
        return out


def read(prof, window_s: float) -> Trace:
    """The Trace of a finished torch.profiler.profile."""
    tr = Trace(window_s=window_s)
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(PROFILER_OWN):
            continue
        s = ev.start_ns()
        item = (ev.name(), s, s + ev.duration_ns())
        if str(ev.device_type()).endswith("CPU"):
            tr.host.append(item)
        elif not ev.is_user_annotation():
            # user annotations (record_function spans, the optimizer's
            # step) are mirrored on the device's timeline but run nothing
            tr.device.append(item)
    return tr
