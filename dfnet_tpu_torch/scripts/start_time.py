"""Start-up time of the port's three CLIs: seconds from launching the
process to the end of its first training step, cold (an empty kernel build
directory, so the CUDA kernels compile) and warm (the same directory kept).

    python -m dfnet_tpu_torch.scripts.start_time

Each CLI runs at its shipped config (configs/config_nerfh.txt,
config_dfnet.txt, config_dfnetdm.txt) on a 7-Scenes replica written first
(scripts/replica.py at the dataset's 480x640 frames, N_FRAMES a sequence),
in a child process that records, by the wall clock, when its first line
ran, when the CLI module was imported, when the trainer's construction
began (the CLI has parsed its flags and loaded the scene) and ended (the
model on the device), when the first train step was called (stage 2
pre-renders and refreshes RVS before it) and when its work had finished
on the device (the step is wrapped to synchronise and report, and the
child then exits). Stage 2 starts from the random NeRF
(no stage-1 checkpoint: the pre-render's cost is the same) and stage 3
from a DFNet checkpoint of the seeded init. GPU only.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
N_FRAMES = 50

# run in the child: python -c CHILD <build root> <stage> <argv as JSON>
CHILD = r"""
import time
t_start = time.time()
import json, os, sys
from pathlib import Path
import torch
from dfnet_tpu_torch.ops import build
build.BUILD_ROOT = Path(sys.argv[1])
stage, argv = sys.argv[2], json.loads(sys.argv[3])
if stage == "nerf":
    from dfnet_tpu_torch.cli import nerf as cli
    from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer as T
elif stage == "feature":
    from dfnet_tpu_torch.cli import feature as cli
    from dfnet_tpu_torch.training.feature_trainer import FeatureTrainer as T
else:
    from dfnet_tpu_torch.cli import dm as cli
    from dfnet_tpu_torch.training.dm_trainer import DMTrainer as T
marks = {"start": t_start, "imported": time.time()}
init, step = T.__init__, T.train_step

def timed_init(self, *a, **k):
    marks.setdefault("trainer_init", time.time())
    init(self, *a, **k)
    torch.cuda.synchronize()
    marks.setdefault("trainer_ready", time.time())

def first_step(self, *a, **k):
    marks["step_called"] = time.time()
    out = step(self, *a, **k)
    torch.cuda.synchronize()
    marks["first_step"] = time.time()
    print("START_TIMES " + json.dumps(marks), flush=True)
    os._exit(0)

T.__init__, T.train_step = timed_init, first_step
cli.main(argv)
raise SystemExit("the CLI returned before its first train step")
"""


def stage_argv(datadir: str, basedir: str, ckpt: str) -> dict:
    common = ["--datadir", datadir, "--basedir", basedir]
    return {
        "nerf": ["--config", "configs/config_nerfh.txt", *common],
        "feature": ["--config", "configs/config_dfnet.txt", *common],
        "dm": ["--config", "configs/config_dfnetdm.txt", *common,
               "--pretrain_model_path", ckpt, "--pretrain_featurenet_path", ckpt],
    }


def run_child(build_root: str, stage: str, argv: list) -> dict:
    """One CLI process to its first step; the seconds from launch to each
    of the child's marks."""
    t0 = time.time()
    out = subprocess.run([sys.executable, "-c", CHILD, build_root, stage, json.dumps(argv)],
                         cwd=ROOT, capture_output=True, text=True)
    line = next((ln for ln in out.stdout.splitlines() if ln.startswith("START_TIMES ")), None)
    if out.returncode != 0 or line is None:
        raise RuntimeError(f"{stage}: exit {out.returncode}\n{out.stdout[-3000:]}\n"
                           f"{out.stderr[-3000:]}")
    marks = json.loads(line[len("START_TIMES "):])
    return {k: v - t0 for k, v in marks.items()}


def main() -> dict:
    import torch

    from dfnet_tpu_torch.models.dfnet import (DFNetConfig, dfnet_params_to_jax,
                                              init_dfnet_params)
    from dfnet_tpu_torch.scripts.replica import write_seven_scenes_replica
    from dfnet_tpu_torch.training.checkpoints import save_pytree

    if not torch.cuda.is_available():
        raise SystemExit("start_time: no CUDA device")
    res = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip()}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        datadir = write_seven_scenes_replica(tmp, n_frames=N_FRAMES, device="cuda")["datadir"]
        res["replica_s"] = time.perf_counter() - t
        ckpt = os.path.join(tmp, "dfnet_init.npz")
        params, state = dfnet_params_to_jax(*init_dfnet_params(
            torch.Generator().manual_seed(0), DFNetConfig(), "cpu"))
        save_pytree(ckpt, {"params": params, "state": state})
        for stage, cli_argv in stage_argv(datadir, os.path.join(tmp, "logs"), ckpt).items():
            build_root = os.path.join(tmp, f"build_{stage}")      # empty: cold
            res[stage] = {"cold": run_child(build_root, stage, cli_argv),
                          "warm": run_child(build_root, stage, cli_argv)}
            print(f"[start] {stage}: " + "; ".join(
                f"{k} " + ", ".join(f"{m} {v:.2f} s" for m, v in r.items())
                for k, r in res[stage].items()), flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
