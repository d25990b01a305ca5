"""Readings of the check's numbers with the reference put in the
program's place, which set each limit's upper end (the benchmark's own
runs never run this).

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \\
        [--what fp8,half_batch,answer_altered] [--out file.jsonl]

`fp8` is the control: the reference at fp8 operands, one precision step
below the kernels' bf16 operands. The others are faults planted in the
reference (the generators' `control_readings`). Each reading is at the
cell's own sizes; one JSON line a seed and reading, also appended to
--out.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path


def readings(workload: str, seed: int, what: str, device: str = "cuda",
             config_override=None, workload_override=None):
    from benchmark import harness

    spec = harness.load_spec()
    entry = harness.cell_entry(spec, workload)
    wl = harness.workload_file(workload)
    wl.update(workload_override or {})
    cfg = harness.config_file(spec, entry["config"])
    cfg.update(config_override or {})
    generator = importlib.import_module(f"benchmark.generators.{wl['generator']}")
    cell = generator.Cell(cfg, wl, seed, device)
    cell.make_inputs()
    return cell.control_readings(what)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="fp8")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    for what in args.what.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            vals = readings(args.workload, seed, what, args.device)
            line = json.dumps({"workload": args.workload, "what": what, "seed": seed,
                               "readings": vals, "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    sys.exit(main())
