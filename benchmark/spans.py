"""The program's own phase regions in a traced run: the device's idle time
put down to the phase that left it idle, and the kernel launches and host
waits of a unit of work.

The program opens its regions with dfnet_tpu_torch/utils/profiling.py's
`annotate` (torch.profiler user annotations named `dfnet.<stage>.<phase>`,
on the trace's clock). A unit of work is one root region: a view
(`dfnet.render.view`), a stage-1 step (`dfnet.train.step`) or a stage-3
step (`dfnet.dm.step`); every phase region of the unit nests inside its
root. The idle time is that between the merged device intervals
(Trace.merged), cut exactly at the regions' edges: each instant of it goes
to the innermost (shortest) program region that contains it, on any host
thread, or to `outside` where none does (the benchmark's loop, its copies
to the host). A root's own (self) time is the phase named after it:
`view` or `step`.

A trace without the program's regions (a program that opens none) gives
no numbers: each reader returns None.
"""

from __future__ import annotations

import bisect
import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

PREFIX = "dfnet."
OUTSIDE = "outside"
# each stage's root region: the phase that holds the root's own time
ROOTS = {"render": "view", "train": "step", "dm": "step"}
LAUNCHES = ("cudaLaunch", "cuLaunch")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")

Event = Tuple[str, int, int]       # name, start, end (ns)


@dataclass
class Spans:
    idle_ns: Dict[str, int] = field(default_factory=dict)    # region name or OUTSIDE
    launches: Dict[str, int] = field(default_factory=dict)   # root name -> inside them
    syncs: Dict[str, int] = field(default_factory=dict)


def innermost(regions: Sequence[Event]) -> List[Event]:
    """Disjoint pieces (name, start, end) of the regions' union, in time
    order, each named after the shortest region that covers it (the later
    start, then the name, where two are as short)."""
    regions = sorted((r for r in regions if r[2] > r[1]), key=lambda r: r[1])
    cuts = sorted({t for _, s, e in regions for t in (s, e)})
    out: List[Event] = []
    active: List[Tuple[int, int, str, int]] = []     # (length, -start, name, end)
    i = 0
    for a, b in zip(cuts, cuts[1:]):
        while i < len(regions) and regions[i][1] <= a:
            n, s, e = regions[i]
            heapq.heappush(active, (e - s, -s, n, e))
            i += 1
        while active and active[0][3] <= a:
            heapq.heappop(active)
        if not active:
            continue
        name = active[0][2]
        if out and out[-1][0] == name and out[-1][2] == a:
            out[-1] = (name, out[-1][1], b)
        else:
            out.append((name, a, b))
    return out


def split_idle(gaps: Sequence[Tuple[int, int]], pieces: Sequence[Event]) -> Dict[str, int]:
    """ns of each piece's name inside the gaps (sorted, disjoint), and the
    rest of the gaps under OUTSIDE: the values sum to the gaps' length."""
    out: Dict[str, int] = {}
    j = 0
    for gs, ge in gaps:
        while j < len(pieces) and pieces[j][2] <= gs:
            j += 1
        covered, k = 0, j
        while k < len(pieces) and pieces[k][1] < ge:
            name, ps, pe = pieces[k]
            part = min(ge, pe) - max(gs, ps)
            if part > 0:
                out[name] = out.get(name, 0) + part
                covered += part
            k += 1
        out[OUTSIDE] = out.get(OUTSIDE, 0) + (ge - gs - covered)
    return out


def count_inside(events: Sequence[Event], roots: Sequence[Event]) -> int:
    """The events that lie wholly inside one of the roots (disjoint)."""
    roots = sorted(roots, key=lambda r: r[1])
    starts = [s for _, s, _ in roots]
    n = 0
    for _, s, e in events:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= roots[i][2]:
            n += 1
    return n


def read(trace) -> Spans:
    """The Spans of a profile_reader.Trace."""
    regions = [h for h in trace.host if h[0].startswith(PREFIX)]
    merged = trace.merged()
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)
            if merged[i + 1][0] > merged[i][1]]
    out = Spans(idle_ns=split_idle(gaps, innermost(regions)))
    launches = [h for h in trace.host if h[0].startswith(LAUNCHES)]
    syncs = [h for h in trace.host if h[0] in SYNCS]
    for stage, phase in ROOTS.items():
        name = f"{PREFIX}{stage}.{phase}"
        roots = [r for r in regions if r[0] == name]
        if roots:
            out.launches[name] = count_inside(launches, roots)
            out.syncs[name] = count_inside(syncs, roots)
    return out


def of(run) -> Optional[Spans]:
    """The run's Spans, read once and kept on the run; None without a trace
    or without device events."""
    if run.trace is None or not run.trace.device:
        return None
    if getattr(run, "spans", None) is None:
        run.spans = read(run.trace)
    return run.spans


def _root(stage: str) -> str:
    return f"{PREFIX}{stage}.{ROOTS[stage]}"


def _units(run, stage: str) -> Optional[Tuple[Spans, int]]:
    sp = of(run)
    units = getattr(run, "units", 0)
    if sp is None or _root(stage) not in sp.launches or not units:
        return None
    return sp, units


def idle_ms(run, stage: str, phase: str) -> Optional[float]:
    """ms of device idle a unit under the phase's own time (`view`/`step`:
    the root's own time); None where the trace holds no root of the stage."""
    got = _units(run, stage)
    if got is None:
        return None
    sp, units = got
    return sp.idle_ns.get(f"{PREFIX}{stage}.{phase}", 0) / units / 1e6


def launches(run, stage: str) -> Optional[float]:
    """Kernel launches a unit, inside the stage's root regions."""
    got = _units(run, stage)
    return None if got is None else got[0].launches[_root(stage)] / got[1]


def syncs(run, stage: str) -> Optional[float]:
    """Host waits for the device a unit, inside the stage's root regions."""
    got = _units(run, stage)
    return None if got is None else got[0].syncs[_root(stage)] / got[1]
