"""Whole runs of the harness on the CPU at small sizes (the program's
kernels run their plain versions there): a sound run is correct, a run
whose timed path is broken underneath is not, the fp8 control fails the
limits, and a cell made of added data files alone runs.

The harness's look for a card is skipped with `--device cpu`; the sizes
come in through --config-override / --workload-override."""

import io
import json
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

from benchmark import control, harness, run

RENDER = {"H": 12, "W": 16, "focal": 15.0, "pool_views": 4, "warmup_views": 1}
TRAIN = {"H": 12, "W": 16, "focal": 15.0, "frames": 4}
TRAIN_NET = {"netwidth": 32, "netwidth_fine": 32, "N_rand": 64, "N_samples": 8,
             "N_importance": 8}
DM = {"H": 96, "W": 128, "focal": 120.0, "frames": 3}
SIZES = {"nerfh_w128.render_exact": ({}, RENDER),
         "nerfh_w128.render_culled": ({}, RENDER),
         "nerfh_w256.train": (TRAIN_NET, TRAIN),
         "nerfh_w128.dm": ({}, DM)}


def drive(cell, seed=5, trace=0, seconds=1.0):
    """run.main on the CPU; the parsed result line."""
    cfg, wl = SIZES[cell]
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace), "--device", "cpu",
                       "--config-override", json.dumps(cfg),
                       "--workload-override", json.dumps(wl)])
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("cell", list(SIZES))
def test_a_sound_run_is_correct(cell):
    res = drive(cell, seed=2**31 + 17)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] > 0
    spec = harness.load_spec()
    assert set(res["metrics"]) == set(harness.end_to_end_names(spec, cell))


def test_a_traced_run_reports_device_and_breakdown():
    res = drive("nerfh_w128.render_exact", trace=1)
    assert res["correct"] and "busy_s" in res["device"] and "breakdown" in res
    assert res["metrics"] == {}      # no device events on the CPU: nothing to read


def _render_altered(monkeypatch):
    from dfnet_tpu_torch.render import fast

    orig = fast.render_rays_fast

    def altered(*a, **k):
        out = dict(orig(*a, **k))
        out["rgb"] = out["rgb"] + 0.05
        return out
    monkeypatch.setattr(fast, "render_rays_fast", altered)


def _render_half(monkeypatch):
    from dfnet_tpu_torch.render import fast

    orig = fast.render_rays_fast

    def half(fast_nerf, rays_o, rays_d, *a, **k):
        n = rays_o.shape[0] // 2
        out = orig(fast_nerf, rays_o[:n], rays_d[:n], *a, **k)
        return {key: torch.cat([v, torch.zeros_like(v)])[:rays_o.shape[0]]
                for key, v in out.items()}
    monkeypatch.setattr(fast, "render_rays_fast", half)


def _train_unchanged(monkeypatch):
    from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer

    monkeypatch.setattr(NeRFTrainer, "adam_update", lambda self, lr: None)


def _train_half(monkeypatch):
    from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer

    orig = NeRFTrainer.draw_batch

    def half(self, idx):
        ro, rd, t, h = orig(self, idx)
        n = ro.shape[0] // 2
        return ro[:n], rd[:n], t[:n], h
    monkeypatch.setattr(NeRFTrainer, "draw_batch", half)


def _train_altered(monkeypatch):
    from dfnet_tpu_torch.ops import nerf_kernels as nk

    orig = nk.fine_raw_t

    def altered(packed, rays_o, rays_d, z, dpt, spec):
        out = orig(packed, rays_o, rays_d, z, dpt, spec)
        return out + torch.eye(out.shape[0], 1).reshape(-1, 1, 1) if spec.fine else out
    monkeypatch.setattr(nk, "fine_raw_t", altered)


def _dm_unchanged(monkeypatch):
    from dfnet_tpu_torch.training.dm_trainer import DMTrainer

    monkeypatch.setattr(DMTrainer, "adam_update", lambda self: None)


def _dm_altered(monkeypatch):
    from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF

    orig = FrozenNeRF.render_fn
    monkeypatch.setattr(FrozenNeRF, "render_fn",
                        lambda self, *a: orig(self, *a) + 0.05)


@pytest.mark.parametrize("cell,fault", [
    ("nerfh_w128.render_exact", _render_altered),
    ("nerfh_w128.render_exact", _render_half),
    ("nerfh_w128.render_culled", _render_altered),
    ("nerfh_w128.render_culled", _render_half),
    ("nerfh_w256.train", _train_unchanged),
    ("nerfh_w256.train", _train_half),
    ("nerfh_w256.train", _train_altered),
    ("nerfh_w128.dm", _dm_unchanged),
    ("nerfh_w128.dm", _dm_altered),
], ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = drive(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", list(SIZES))
def test_the_fp8_control_fails_the_limits(cell):
    cfg, wl = SIZES[cell]
    limits = harness.workload_file(cell)["check"]["limits"]
    got = control.readings(cell, 3, "fp8", "cpu", cfg, wl)
    assert any(got[k] > limits[k] for k in limits), (got, limits)


def test_a_cell_of_added_data_files_runs(tmp_path, monkeypatch):
    """A new traffic file and a BENCHMARK.json entry make a cell: no file
    the benchmark has is edited."""
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    wl = json.loads((bench / "workloads" / "nerfh_w128.render_exact.json").read_text())
    wl.update(name="nerfh_w128.render_wide", H=14, W=20, focal=18.0)
    (bench / "workloads" / "nerfh_w128.render_wide.json").write_text(json.dumps(wl))
    spec = harness.load_spec()
    spec["workloads"].append({"name": "nerfh_w128.render_wide", "config": "nerfh_w128",
                              "traffic": "render_wide", "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "nerfh_w128.render_exact" in m.get("workloads", []):
            m["workloads"].append("nerfh_w128.render_wide")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "BENCH", bench)
    monkeypatch.setattr(harness, "load_spec", lambda path=tmp_path / "BENCHMARK.json":
                        json.loads(path.read_text()))
    SIZES["nerfh_w128.render_wide"] = ({}, {"pool_views": 3, "warmup_views": 1})
    try:
        res = drive("nerfh_w128.render_wide")
    finally:
        del SIZES["nerfh_w128.render_wide"]
    assert res["correct"] and "render_rays_per_s" in res["metrics"]


def test_harness_and_program_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); "
            "import benchmark.run, benchmark.control, benchmark.generators.render, "
            "benchmark.generators.train, benchmark.generators.dm, benchmark.reference_nerfh, "
            "benchmark.reference_dfnet; "
            "import dfnet_tpu_torch.training.nerf_trainer, dfnet_tpu_torch.render.fast, "
            "dfnet_tpu_torch.training.dm_trainer; "
            "from benchmark.harness import forbidden_modules; "
            "print(forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.'); import benchmark.reference_nerfh, "
            "benchmark.reference_dfnet, benchmark.frozen, benchmark.scene; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'dfnet_tpu_torch', 'dfnet_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_the_whole_name_check():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "dfnet_tpu",
             "dfnet_tpu.ops", "dfnet_tpu_torch", "dfnet_tpu_torch.ops", "jaxtyping", "numpy"]
    assert harness.forbidden_modules(names) == sorted(names[:6])


def test_a_run_that_loaded_jax_exits_without_a_result():
    pytest.importorskip("jax")
    cfg, wl = SIZES["nerfh_w128.render_exact"]
    code = ("import sys; sys.path.insert(0, '.'); import jax; from benchmark import run; "
            f"sys.exit(run.main(['--workload', 'nerfh_w128.render_exact', '--seed', '1', "
            f"'--seconds', '1', '--device', 'cpu', '--workload-override', "
            f"{json.dumps(json.dumps(wl))}]))")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                       text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "jax" in p.stderr
