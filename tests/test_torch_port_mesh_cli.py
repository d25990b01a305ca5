"""The three CLIs of the port at --mesh_shape 2 --device cpu (two gloo
processes a stage, spawned by parallel/mesh.py::launch) against
--mesh_shape 1, on the CPU: the logged losses of every epoch within rtol
1e-3 (the JAX package's CLI bar, tests/test_cli.py:102), the checkpoints
each stage writes (rank 0 alone writes: the same files as world 1's),
stage 2 reading stage 1's mesh checkpoint and stage 3 stage 2's. Small
nets (D=2, W=32, 16 + 16 samples) on the 48x64 synthetic scene; world 1
runs on one torch thread, as each rank does, and its three CLIs share one
load of the scene (each rank loads its own). Stage 3 runs at learning
rate 0, so its logged losses are F's initial losses over every train and
val view through the split render: an epoch of DM steps is chaotic at
float32 rounding (the DM gradient is rough in the pose, ROADMAP.md Queue
3; world 1 alone moves its epoch's train loss by 3.9e-3 between one and
four threads), and the step's gradients are held in
tests/test_torch_port_mesh_dm.py. And the repair: the stage-1
CLI at --mesh_shape 2 runs two ranks (the parent's trained on one device
and said nothing)."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import contextlib
import copy
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from dfnet_tpu_torch.cli import dm as dm_cli
from dfnet_tpu_torch.cli import feature as feature_cli
from dfnet_tpu_torch.cli import nerf as nerf_cli
from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.loader import load_scene

NET = ["--dataset_type", "synthetic", "--NeRFH", "--encode_hist", "--netdepth", "2",
       "--netwidth", "32", "--netdepth_fine", "2", "--netwidth_fine", "32",
       "--N_samples", "16", "--N_importance", "16", "--expname", "nerfh", "--device", "cpu"]
STAGE1 = NET + ["--N_rand", "96", "--epochs", "1", "--i_weights", "1", "--i_testset", "2"]
STAGE2 = NET + ["--model_name", "dfnet", "--DFNet", "--featurenet_batch_size", "2",
                "--tripletloss", "--tinyimg", "--random_view_synthesis",
                "--feature_precision", "fp32", "--epochs", "0", "--i_eval", "1"]
STAGE3 = NET + ["--N_rand", "128", "--model_name", "dfnetdm", "--DFNet", "--combine_loss",
                "--combine_loss_w", "[0.,0.,1.]", "--feature_matching_lvl", "[0]",
                "--svd_reg", "--val_on_psnr", "--feature_precision", "fp32",
                "--learning_rate", "0", "--epochs", "0", "--i_eval", "1"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _stdout_fd(log: list):
    """Collect what this process prints and what the ranks it spawns write
    to file descriptor 1 (rank 0 prints there) into `log`."""
    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile(mode="w+") as tmp:
        os.dup2(tmp.fileno(), 1)
        try:
            with contextlib.redirect_stdout(tmp):
                yield
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
            tmp.seek(0)
            log.append(tmp.read())


def _metrics(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    scene = load_scene(parse_args(STAGE1))
    patch = pytest.MonkeyPatch()
    for cli in (nerf_cli, feature_cli, dm_cli):
        patch.setattr(cli, "load_scene", lambda cfg, stage="nerf": copy.deepcopy(scene))
    try:
        yield _runs(tmp_path_factory)
    finally:
        patch.undo()


def _runs(tmp_path_factory):
    """Stages 1-3 through the CLIs at world 2, each stage from the previous
    stage's world-2 checkpoint; then at world 1, each stage from the same
    inputs as world 2's (stage 2 from its NeRF checkpoint by --ft_path,
    stage 3 also from its DFNet checkpoint), so that each comparison is of
    one stage's mesh alone."""
    out, nerf_in, dfnet_in = {}, [], []
    for world in (2, 1):
        base = str(tmp_path_factory.mktemp(f"world{world}"))
        mesh = ["--mesh_shape", str(world), "--basedir", base]
        log = []
        with _stdout_fd(log):
            nerf_cli.train(STAGE1 + mesh)
        out[f"log{world}"] = log[0]
        nerf_in = nerf_in or ["--ft_path", os.path.join(base, "nerfh", "000001.npz")]
        feature_cli.train(STAGE2 + mesh + nerf_in)
        if not dfnet_in:
            best = sorted(f for f in os.listdir(os.path.join(base, "dfnet"))
                          if f.endswith(".npz"))[-1]
            dfnet_in = ["--pretrain_model_path", os.path.join(base, "dfnet", best)]
        dm_cli.train(STAGE3 + mesh + nerf_in + dfnet_in)
        out[world] = {sub: (_metrics(os.path.join(base, sub, "metrics.jsonl")),
                            sorted(os.listdir(os.path.join(base, sub))))
                      for sub in ("nerfh", "dfnet", "dfnetdm")}
    return out


@pytest.mark.parametrize("stage, keys", [
    ("nerfh", ("loss", "psnr")),
    ("dfnet", ("train_loss", "val_loss")),
    ("dfnetdm", ("train_loss", "train_psnr", "val_loss", "val_psnr")),
])
def test_cli_world2_losses_match_world1(runs, stage, keys):
    """Every epoch's logged values at rtol 1e-3, the world size logged."""
    (m1, _), (m2, _) = runs[1][stage], runs[2][stage]
    assert len(m1) == len(m2) > 0
    for k in keys:
        np.testing.assert_allclose([r[k] for r in m2], [r[k] for r in m1], rtol=1e-3,
                                   err_msg=k)
    assert [r["world"] for r in m1] == [1] * len(m1)
    assert [r["world"] for r in m2] == [2] * len(m2)


@pytest.mark.parametrize("stage", ["nerfh", "dfnet", "dfnetdm"])
def test_cli_world2_writes_what_world1_writes(runs, stage):
    """Rank 0 alone writes: the same checkpoint names (stage 1's epoch-1
    checkpoint; stages 2 and 3 early stopping's, named by their val
    metric) and no stray file. At world 2, stage 2 loaded stage 1's
    checkpoint and stage 3 stage 2's (the fixture hands each on)."""
    names1, names2 = runs[1][stage][1], runs[2][stage][1]
    strip = lambda names: [n.split("-")[:2] for n in names]
    assert strip(names2) == strip(names1)
    assert any(n.endswith(".npz") for n in names2)


def test_stage1_cli_mesh_shape_2_runs_two_ranks(runs):
    """The repair: --mesh_shape 2 --device cpu spawns two ranks (rank 0's
    first line names the backend, the world size and the devices; rank 1
    prints nothing), the run line and metrics.jsonl record world 2;
    --mesh_shape 1 runs alone."""
    log2, log1 = runs["log2"], runs["log1"]
    assert log2.startswith("[mesh] gloo, world size 2, devices cpu\n"), log2[:300]
    assert log2.count("world=2") == 1 and log2.count("[TRAIN] Iter: 1 ") == 1
    assert "[mesh]" not in log1 and "world=1" in log1
    assert [r["world"] for r in runs[2]["nerfh"][0]] == [2, 2]
