"""The original NeRF's train cell (nerf_vanilla.train) run whole on the CPU at
a small size (the kernels run their plain versions there): a sound run is
correct and every step took the kernel route; each fault of PERF.md
section 2 fails `correct` (the state left unchanged, half the batch, an
altered answer, a step on the plain route), and so does the fp8 control."""

import io
import json
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

from benchmark import control, harness, run

CELL = "nerf_vanilla.train"
NET = {"netwidth": 32, "netwidth_fine": 32, "N_rand": 64, "N_samples": 8, "N_importance": 16}
TRAFFIC = {"H": 12, "W": 16, "focal": 15.0, "frames": 4, "frame_samples": 32,
           "reference_block": 32}


@pytest.fixture
def drive(monkeypatch):
    """run.main on the CPU: the parsed result line. A module that another
    test loaded into this process before the run (test_bench_runs.py's JAX)
    is not held against the run; what the run itself loads still is."""
    def go(seed=5):
        before = set(sys.modules)
        forbidden = harness.forbidden_modules
        monkeypatch.setattr(harness, "forbidden_modules",
                            lambda names: forbidden([n for n in names if n not in before]))
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "1",
                           "--trace", "0", "--device", "cpu", "--config-override",
                           json.dumps(NET), "--workload-override", json.dumps(TRAFFIC)])
        assert rc == 0
        return json.loads(buf.getvalue().strip().splitlines()[-1])
    return go


@pytest.fixture(autouse=True)
def two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_a_sound_run_is_correct_on_the_kernel_route(drive):
    res = drive(seed=2**31 + 17)
    assert res["correct"], res["checks"]
    assert res["checks"]["plain_route_steps"]["value"] == 0.0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"train_rays_per_s", "setup_s"}


def _unchanged(monkeypatch):
    from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer

    monkeypatch.setattr(NeRFTrainer, "adam_update", lambda self, lr: None)


def _half(monkeypatch):
    from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer

    orig = NeRFTrainer.draw_batch

    def half(self, idx):
        ro, rd, t, h = orig(self, idx)
        n = ro.shape[0] // 2
        return ro[:n], rd[:n], t[:n], h
    monkeypatch.setattr(NeRFTrainer, "draw_batch", half)


def _altered(monkeypatch):
    """The fine net's raw rgb out by one: the sweep over the union."""
    from dfnet_tpu_torch.ops import nerf_kernels as nk

    orig = nk.fine_raw_t

    def altered(packed, rays_o, rays_d, z, dpt, spec):
        out = orig(packed, rays_o, rays_d, z, dpt, spec)
        shift = torch.tensor([1.0, 1.0, 1.0, 0.0]).reshape(-1, 1, 1)
        return out + shift if z.shape[1] > NET["N_samples"] else out
    monkeypatch.setattr(nk, "fine_raw_t", altered)


def _plain(monkeypatch):
    """Every step after set-up's first on the plain route: the same loss and
    draws, which only the route counter tells apart."""
    from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer

    orig = NeRFTrainer.schedule

    def schedule(self, epoch):
        settings, fused = orig(self, epoch)
        self.steps_seen = getattr(self, "steps_seen", 0) + 1
        return settings, fused and self.steps_seen == 1
    monkeypatch.setattr(NeRFTrainer, "schedule", schedule)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered, _plain],
                         ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch, drive):
    fault(monkeypatch)
    res = drive()
    assert not res["correct"], res["checks"]


def test_the_route_counter_catches_the_plain_route(monkeypatch, drive):
    _plain(monkeypatch)
    checks = drive()["checks"]
    assert checks["plain_route_steps"]["value"] > 0


def test_the_fp8_control_fails_the_limits():
    limits = harness.workload_file(CELL)["check"]["limits"]
    got = control.readings(CELL, 3, "fp8", "cpu", NET, TRAFFIC)
    assert any(got[k] > limits[k] for k in got), (got, limits)


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.'); import benchmark.reference_nerf; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'dfnet_tpu_torch', 'dfnet_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"
