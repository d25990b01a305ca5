"""benchmark/spans.py on synthetic traces: each idle gap cut exactly over
the innermost program regions, the phases and `outside` summing to the
inter-op idle to the nanosecond, launches and host waits counted by
containment in the roots, and the readers of the new metrics returning
nothing where the trace holds nothing to read."""

import random

import pytest

from benchmark import harness, spans
from benchmark.profile_reader import Trace

SPAN_METRICS = [m["name"] for m in harness.load_spec()["per_layer"]
                if m["source"] == "program_span" and m["name"] != "dm_render_ms"]


class Run:
    def __init__(self, trace, units=1):
        self.trace, self.units, self.kernels = trace, units, {}


def _trace(device, host):
    return Trace(window_s=1.0, device=[("k", s, e) for s, e in device], host=list(host))


def _brute(trace):
    """ns by innermost region (or outside), one instant at a time."""
    merged = trace.merged()
    regions = [h for h in trace.host if h[0].startswith("dfnet.")]
    out = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        for t in range(a, b):
            inside = [(e - s, -s, n) for n, s, e in regions if s <= t < e]
            key = min(inside)[2] if inside else spans.OUTSIDE
            out[key] = out.get(key, 0) + 1
    return out


def test_each_gap_is_split_over_the_innermost_regions():
    # device busy [0,10) [30,40) [100,110) [130,140): gaps 20 + 60 + 20 ns;
    # backward [50,90) and, as if on autograd's thread, a shorter region
    # [70,95) that overlaps it without nesting
    host = [("dfnet.train.step", 5, 120), ("dfnet.train.sample", 20, 35),
            ("dfnet.train.fine", 22, 25), ("dfnet.train.backward", 50, 90),
            ("dfnet.train.adam", 70, 95), ("aten::mm", 12, 90), ("cudaLaunchKernel", 60, 61)]
    t = _trace([(0, 10), (30, 40), (100, 110), (130, 140)], host)
    got = spans.read(t).idle_ns
    assert got == {"dfnet.train.step": 10 + 10 + 5 + 10, "dfnet.train.sample": 2 + 5,
                   "dfnet.train.fine": 3, "dfnet.train.backward": 20,
                   "dfnet.train.adam": 25, spans.OUTSIDE: 10}
    assert got == _brute(t)


@pytest.mark.parametrize("seed", range(6))
def test_phases_and_outside_sum_to_the_inter_op_idle(seed):
    rng = random.Random(seed)
    device = []
    t = 0
    for _ in range(30):
        t += rng.randint(0, 9)
        d = rng.randint(1, 12)
        device.append((t, t + d))
        t += rng.randint(0, d)               # overlapping device events merge
    host = []
    for u in range(4):                         # units, each a root with nested phases
        s = rng.randint(0, t)
        e = s + rng.randint(1, 80)
        host.append(("dfnet.render.view", s, e))
        for _ in range(rng.randint(0, 5)):
            a = rng.randint(s, e)
            host.append((rng.choice(["dfnet.render.sample", "dfnet.render.fine"]), a,
                         rng.randint(a, e)))
    host.append(("dfnet.train.backward", 3, 3))   # empty: takes nothing
    tr = _trace(device, host)
    got = spans.read(tr).idle_ns
    merged = tr.merged()
    idle = sum(b - a for (_, a), (b, _) in zip(merged, merged[1:]))
    assert sum(got.values()) == idle
    assert {k: v for k, v in got.items() if v} == _brute(tr)


def test_launches_and_syncs_are_counted_by_containment():
    host = [("dfnet.dm.step", 100, 200), ("dfnet.dm.step", 300, 400),
            ("dfnet.dm.backward", 150, 190),
            ("cudaLaunchKernel", 110, 112), ("cuLaunchKernel", 160, 161),
            ("cudaLaunchKernelExC", 399, 400), ("cudaLaunchKernel", 50, 60),
            ("cudaLaunchKernel", 199, 201),           # crosses the root's end
            ("cudaStreamSynchronize", 170, 180), ("cudaDeviceSynchronize", 310, 320),
            ("cudaEventSynchronize", 330, 331), ("cudaStreamSynchronize", 250, 260),
            ("cudaMemcpyAsync", 120, 125)]
    run = Run(_trace([(0, 1), (500, 501)], host), units=2)
    sp = spans.read(run.trace)
    assert sp.launches == {"dfnet.dm.step": 3} and sp.syncs == {"dfnet.dm.step": 3}
    assert spans.launches(run, "dm") == 1.5 and spans.syncs(run, "dm") == 1.5
    assert spans.launches(run, "train") is None      # no stage-1 root in the trace


def test_readers_read_per_unit_and_once_per_run():
    host = [("dfnet.render.view", 0, 100), ("dfnet.render.pack", 5, 20),
            ("dfnet.render.view", 100, 200), ("cudaLaunchKernel", 6, 7)]
    run = Run(_trace([(0, 5), (20, 25), (150, 160)], host), units=2)
    first = spans.of(run)
    assert spans.of(run) is first
    assert harness.read_metric("idle_ms.pack.render", run) == 15 / 2 / 1e6
    assert harness.read_metric("idle_ms.view.render", run) == 125 / 2 / 1e6
    assert harness.read_metric("idle_ms.sample.render", run) == 0.0
    assert harness.read_metric("launches.render", run) == 0.5
    assert harness.read_metric("syncs.render", run) == 0.0


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_every_new_reader_returns_nothing_without_device_events_or_regions(metric):
    regions = [(f"dfnet.{s}.{p}", 0, 100) for s, p in spans.ROOTS.items()]
    read = harness.metric_reader(metric).read
    assert read(Run(None)) is None
    assert read(Run(_trace([], regions))) is None                    # no device events
    assert read(Run(_trace([(0, 5), (50, 60)], [("aten::mm", 0, 60)]))) is None  # no regions
    assert read(Run(_trace([(0, 5), (50, 60)], regions))) is not None
