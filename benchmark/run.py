"""Run one cell of the benchmark of dfnet_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or `python3 -m benchmark.run ...`) from the root of a checkout, on a
machine with the cards the cell asks for. The run makes its inputs from
the seed, loads and warms up the program (set-up), drives the cell's
entry for --seconds (the window), then checks what the window produced
against the plain reference, and prints one JSON line last on standard
output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1,
read from torch.profiler's trace of the window), `device`, with --trace 1
`breakdown`, and last `checks`, each compared number beside its limit
(also the last lines on standard error).

It exits non-zero and prints no result when CUDA is missing, when the
machine has fewer cards than the cell needs, when the program is not
beside it, or when the process has loaded JAX or the JAX package. The
program's one build cache, its nvcc libraries, lies inside the checkout
(build/dfnet_tpu_torch, ops/build.py), so only a checkout's first run
compiles.
"""

from __future__ import annotations

import time

T_LAUNCH = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the benchmark's own CPU tests: the device, and JSON objects whose
    # keys replace the configuration's and the traffic's (small sizes)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--config-override", default="{}", help=argparse.SUPPRESS)
    p.add_argument("--workload-override", default="{}", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import importlib

    import torch

    from benchmark import harness, profile_reader

    t_imports = time.perf_counter() - T_LAUNCH
    spec = harness.load_spec()
    entry = harness.cell_entry(spec, args.workload)
    wl = harness.workload_file(args.workload)
    wl.update(json.loads(args.workload_override))
    cfg = harness.config_file(spec, entry["config"])
    cfg.update(json.loads(args.config_override))
    dev = harness.device_info(torch, args.device, entry["chips"])
    generator = importlib.import_module(f"benchmark.generators.{wl['generator']}")
    cell = generator.Cell(cfg, wl, args.seed, args.device)

    cell.setup()
    if args.device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_LAUNCH
    parts = ", ".join(f"{k} {v:.3f}" for k, v in cell.marks.parts.items())
    print(f"setup {setup_s:.3f} s: torch and harness imports {t_imports:.3f}, {parts}",
          file=sys.stderr)
    if args.device != "cpu":
        torch.cuda.reset_peak_memory_stats()

    trace = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if args.device != "cpu":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            cell.window(args.seconds)
        trace = profile_reader.read(prof, cell.window_s)
        del prof
    else:
        cell.window(args.seconds)
    dev["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if args.device != "cpu" else 0)
    cell.trace = trace

    if trace is None:
        values = dict(cell.end_to_end(), setup_s=setup_s)
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        metrics = {n: {"value": values[n], "unit": units[n]}
                   for n in harness.end_to_end_names(spec, args.workload)}
    else:
        metrics = {}
        for m in harness.per_layer_entries(spec, args.workload):
            v = harness.read_metric(m["name"], cell)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s

    cell.release()
    checks = cell.check()
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"the run loaded JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    result = {"correct": correct, "attempted": cell.attempted, "failed": cell.failed,
              "metrics": metrics, "device": dev}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
