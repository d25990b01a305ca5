"""What every cell shares: finding a cell's files by name, the checks on
the device and on the modules a run loaded, the tail percentile, and the
per-layer metric readers.

A cell is an entry of BENCHMARK.json's `workloads`. Its traffic is
benchmark/workloads/<cell>.json, whose `generator` names the module
(benchmark/generators/<generator>.py) that reads it; its configuration is the
`file` of the BENCHMARK.json configuration it names. A per-layer metric
is benchmark/metrics/<metric>.py, whose `read(run)` returns the metric
or None when the run holds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
from pathlib import Path
from typing import Dict, Iterable, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
# top-level module names a run may not load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "dfnet_tpu")


def load_spec(path: Path = ROOT / "BENCHMARK.json") -> Dict:
    with open(path) as fh:
        return json.load(fh)


def _read_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def cell_entry(spec: Dict, name: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no cell {name!r} in BENCHMARK.json")


def workload_file(name: str) -> Dict:
    return _read_json(BENCH / "workloads" / f"{name}.json")


def config_file(spec: Dict, name: str) -> Dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return _read_json(ROOT / c["file"])
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def end_to_end_names(spec: Dict, cell: str) -> List[str]:
    """The cell's end-to-end metrics: those that list it, and those that
    list no cells (every cell reports them)."""
    return [m["name"] for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_entries(spec: Dict, cell: str) -> List[Dict]:
    """The cell's per-layer metrics: those that list it, and those with no
    list whose end-to-end metric the cell reports."""
    e2e = set(end_to_end_names(spec, cell))
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def metric_reader(name: str):
    """benchmark/metrics/<name>.py as a module."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_name = "benchmark.metrics." + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The module names whose top-level part (before the first dot) is one
    of FORBIDDEN, compared whole: dfnet_tpu_torch is not dfnet_tpu."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def percentile(values: List[float], pct: int) -> float:
    """The pct-th percentile of values (statistics.quantiles, n=100,
    the 'exclusive' method); the one value when there is one."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100)[pct - 1]


def device_info(torch, device: str, chips: int) -> Dict:
    """platform, kind, count of the run; raises SystemExit when the run
    asks for CUDA and the machine has fewer cards than the cell needs."""
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs on an H100")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards, the machine has "
                         f"{torch.cuda.device_count()}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def read_metric(name: str, run) -> Optional[float]:
    value = metric_reader(name).read(run)
    return None if value is None else float(value)
