"""The port's stage-3 CLI on the CPU: the synthetic stage-3 command
fine-tunes a checkpoint that the port's stage-2 CLI wrote, printing train
and val loss and PSNR each epoch and a median error; `--eval` of its best
checkpoint gives the median error that the JAX package's
`cli.dm.evaluate` prints for the same file; the reference's `.pt` DFNet
and `.tar` NeRF give the losses of the `.npz` files they were exported
from; --mesh_shape 0 on the CPU refuses."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from dfnet_tpu.cli import dm as jax_cli
from dfnet_tpu_torch import convert
from dfnet_tpu_torch.cli import dm as cli
from dfnet_tpu_torch.cli import feature as feature_cli
from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.models.factory import create_nerfh
from dfnet_tpu_torch.training.checkpoints import load_pytree, save_pytree

NERF = ["--dataset_type", "synthetic", "--NeRFH", "--encode_hist",
        "--netdepth", "2", "--netwidth", "32", "--netdepth_fine", "2",
        "--netwidth_fine", "32", "--N_samples", "16", "--N_importance", "16",
        "--expname", "nerfh", "--DFNet"]
# the synthetic stage-3 command at the test NeRF's size, less its
# --pretrain_model_path and --basedir
STAGE3 = NERF + ["--N_rand", "256", "--model_name", "dfnetdm", "--combine_loss",
                 "--combine_loss_w", "0,0,1", "--feature_matching_lvl", "0", "--svd_reg",
                 "--val_on_psnr", "--epochs", "2", "--i_eval", "2"]
EPOCH = re.compile(r"At epoch +(\d+) : train loss: (\S+), train psnr: (\S+), "
                   r"val loss: (\S+), val psnr: (\S+)")
MEDIAN = re.compile(r"Median error (\S+)m and (\S+) degrees\.")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes gain nothing from intra-op threads, and test workers that
    each run a thread a core slow one another down many times over: this
    module's torch ops run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stage2(tmp_path_factory):
    """A basedir holding a stage-1 checkpoint of the command's NeRF and the
    checkpoint of one stage-2 epoch of the port's stage-2 CLI on it."""
    base = tmp_path_factory.mktemp("dmcli")
    cfg = parse_args(NERF + ["--device", "cpu"])
    _, params = create_nerfh(cfg, torch.Generator().manual_seed(3))
    save_pytree(str(base / "nerfh" / "000005.npz"), {"params": params}, global_step=5)
    feature_cli.train(NERF + ["--model_name", "dfnet", "--featurenet_batch_size", "2",
                              "--tripletloss", "--tinyimg", "--epochs", "0", "--i_eval", "1",
                              "--basedir", str(base), "--device", "cpu"])
    (ckpt,) = [f for f in os.listdir(base / "dfnet") if f.startswith("checkpoint-")]
    return base, str(base / "dfnet" / ckpt)


@pytest.fixture(scope="module")
def stage3(stage2, tmp_path_factory):
    """The stage-3 command, 2 epochs from the stage-2 checkpoint: (its
    return, its stdout, the basedir)."""
    _, ckpt = stage2
    base = tmp_path_factory.mktemp("dmrun")
    os.symlink(stage2[0] / "nerfh", base / "nerfh")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        err = cli.main(STAGE3 + ["--basedir", str(base), "--pretrain_model_path", ckpt,
                                 "--device", "cpu"])
    return err, out.getvalue(), base


def test_stage3_command_trains_and_prints_val_psnr(stage3):
    err, out, base = stage3
    assert "[FrozenNeRF] loaded" in out
    epochs = EPOCH.findall(out)
    assert [int(e[0]) for e in epochs] == [0, 1, 2]
    assert np.all(np.isfinite(np.array([e[1:] for e in epochs], float)))
    medians = MEDIAN.findall(out)
    assert len(medians) == 2               # epochs 0 and 2
    np.testing.assert_allclose([float(v) for v in medians[-1]], err[0], rtol=1e-12)
    saved = sorted(os.listdir(base / "dfnetdm"))
    assert saved[0].startswith("checkpoint-0000-") and "metrics.jsonl" in saved
    tree, _ = load_pytree(str(base / "dfnetdm" / saved[0]))
    assert tree["params"]["encoder"]["conv1_1"]["w"].shape == (3, 3, 3, 64)   # JAX layout
    assert set(tree["state"]["adapt"]) == {"0", "1", "2"}


def test_eval_of_the_best_checkpoint_gives_jax_median_error(stage3, capsys):
    """The port's --eval and the JAX package's cli.dm.evaluate on the best
    stage-3 checkpoint: the same median and mean error within 1e-4
    relative (float32 forwards of both packages)."""
    _, _, base = stage3
    best = sorted(f for f in os.listdir(base / "dfnetdm") if f.startswith("checkpoint-"))[-1]
    argv = STAGE3 + ["--basedir", str(base), "--eval", "--pretrain_model_path",
                     str(base / "dfnetdm" / best)]
    med, mean = cli.main(argv + ["--device", "cpu"])
    jax_cli.evaluate(argv + ["--aot_cache_dir", "", "--compilation_cache_dir", ""])
    out = capsys.readouterr().out
    (_, _), (jmed_t, jmed_r) = MEDIAN.findall(out)[:2]
    np.testing.assert_allclose(med, [float(jmed_t), float(jmed_r)], rtol=1e-4, atol=1e-5)
    assert f"Median error {med[0]}m and {med[1]} degrees." in out
    assert np.all(np.isfinite(mean))


@pytest.mark.parametrize("flags, item", [
    (["--mesh_shape", "0"], "item 10"),
    (["--pretrain_model_path", "dfnet.pt"], "item 7"),
    (["--ft_path", "nerf.tar"], "item 7"),
])
def test_unported_flags_refuse(stage2, stage3, tmp_path, flags, item):
    """A mesh the device cannot hold refuses before anything is written:
    --mesh_shape 0 means every local GPU, and on the CPU it raises
    ValueError (the mesh itself, ROADMAP.md Queue 1 item 10, runs: tests/
    test_torch_port_mesh_cli.py). A `.pt` exported from the stage-2
    checkpoint (as DFNet F and G) and a `.tar` exported from the stage-1
    checkpoint (the NeRF, via --ft_path) run (Queue 1 item 7): epoch 0
    from either gives the losses and PSNRs of epoch 0 from the `.npz`
    files, bit for bit."""
    base, ckpt = stage2
    argv = STAGE3 + ["--basedir", str(tmp_path), "--pretrain_model_path", ckpt,
                     "--device", "cpu"]
    if item == "item 10":
        with pytest.raises(ValueError, match="mesh_shape 0 means every local GPU"):
            cli.main(argv + flags)
        assert not os.path.exists(tmp_path / "dfnetdm")
        return
    path = str(tmp_path / flags[1])
    if path.endswith(".pt"):
        convert.main([ckpt, path])
    else:
        convert.main([str(base / "nerfh" / "000005.npz"), path, "--netdepth", "2"])
    os.symlink(base / "nerfh", tmp_path / "nerfh")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv + [flags[0], path, "--epochs", "0"])
    nerf = path if path.endswith(".tar") else str(tmp_path / "nerfh" / "000005.npz")
    assert f"[FrozenNeRF] loaded {nerf}" in out.getvalue()
    with open(tmp_path / "dfnetdm" / "metrics.jsonl") as fh:
        got = [json.loads(line) for line in fh]
    with open(stage3[2] / "dfnetdm" / "metrics.jsonl") as fh:
        want = json.loads(fh.readline())
    keys = ("train_loss", "train_psnr", "val_loss", "val_psnr")
    assert len(got) == 1 and [got[0][k] for k in keys] == [want[k] for k in keys]


def test_no_gpu_raises_without_device_cpu(stage2, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(STAGE3 + ["--basedir", str(tmp_path), "--pretrain_model_path", stage2[1]])
