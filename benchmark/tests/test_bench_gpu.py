"""On the card: one short run of each cell is correct and reports what
the contract asks. Run there with
    python -m pytest benchmark/tests/test_bench_gpu.py"""

import json
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                        "4242", "--seconds", "2", "--trace", "1"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0 and res["metrics"]
