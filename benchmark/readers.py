"""What the per-layer metric readers (benchmark/metrics/) share: each
reads a finished traced run (`run`: the cell, with its Trace in
`run.trace`) and returns None where the run holds nothing to read."""

from __future__ import annotations

from typing import Optional


def idle_pct(run) -> Optional[float]:
    """The share of the traced window in which no operation ran on the
    device."""
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline_pct(run, kernel: str) -> Optional[float]:
    """The kernel's bound over its device time, from the launches in the
    trace: launches / launches a unit of work, times a unit's bound."""
    k = getattr(run, "kernels", {}).get(kernel)
    if run.trace is None or k is None:
        return None
    n_count, _ = run.trace.kernel((k["count"],))
    _, dev_s = run.trace.kernel(k["patterns"])
    if n_count == 0 or dev_s <= 0:
        return None
    bound_s = n_count / k["per_unit"] * k["bound_ms"] / 1e3
    return 100.0 * bound_s / dev_s


def mfu_pct(run) -> Optional[float]:
    """The window's model operations, each at the dense peak of the
    precision it runs in, over the window's wall time: the whole step's
    share of the card's peak."""
    if run.trace is None or run.trace.busy_s <= 0 or not getattr(run, "units", 0):
        return None
    peak_s = sum(ops / peak for ops, peak in run.ops_per_unit) * run.units
    return 100.0 * peak_s / run.window_s
