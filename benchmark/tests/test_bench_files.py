"""BENCHMARK.json against the contract the benchmark keeps, and every
cell's configuration, traffic and metric files found by name."""

import json
import re

import pytest

from benchmark import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    # a full check of 24 cells fits the check's 43,200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(SPEC["workloads"]) <= 24
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"]] + CELLS
    assert all(NAME.match(n) for n in names)
    assert len(set(m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"])) == \
        len(SPEC["end_to_end"] + SPEC["per_layer"])
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    entry = harness.cell_entry(SPEC, cell)
    wl = harness.workload_file(cell)
    cfg = harness.config_file(SPEC, entry["config"])
    assert wl["name"] == cell and cfg["name"] == entry["config"]
    assert cell == f"{entry['config']}.{entry['traffic']}" and entry["chips"] == 1
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]
    e2e = harness.end_to_end_names(SPEC, cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.per_layer_entries(SPEC, cell)
    assert layer and all(m["moves"] in e2e for m in layer)
    for m in layer:
        assert callable(harness.metric_reader(m["name"]).read)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_file_says_what_benchmark_json_says(metric):
    entry = next(m for m in SPEC["per_layer"] if m["name"] == metric)
    mod = harness.metric_reader(metric)
    assert (mod.NAME, mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES, mod.WORKLOADS) == (
        entry["name"], entry["unit"], entry["layer"], entry["source"], entry["moves"],
        entry["workloads"])


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_file_names_its_source_and_cuts(cfg):
    body = json.loads((harness.ROOT / cfg["file"]).read_text())
    assert body["source"] == cfg["source"] and body["reduced"] == cfg["reduced"]
    assert "assumed" in body and cfg["file"].startswith("benchmark/")


def test_readers_return_nothing_without_a_trace():
    class Run:
        trace = None
        kernels = {}
    for m in SPEC["per_layer"]:
        assert harness.metric_reader(m["name"]).read(Run()) is None
