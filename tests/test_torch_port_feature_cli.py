"""The port's stage-2 CLI on the CPU: the synthetic stage-2 command trains
and evaluates on a stage-1 checkpoint the test writes, `--eval` of a
JAX-written DFNet checkpoint gives the JAX package's median error,
--render_feature_only, a reference `.pt` and --vgg_init_path run, and
--mesh_shape 0 on the CPU refuses."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import os
import re

import jax
import numpy as np
import pytest
import torch

from dfnet_tpu.config import parse_args as jax_parse_args
from dfnet_tpu.models.dfnet import init_dfnet_params as jax_init_dfnet
from dfnet_tpu.training.checkpoints import save_pytree as jax_save_pytree
from dfnet_tpu.training.feature_trainer import FeatureTrainer as JaxFeatureTrainer
from dfnet_tpu_torch.cli import feature as cli
from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.convert import export_dfnet_checkpoint
from dfnet_tpu_torch.data.loader import load_scene
from dfnet_tpu_torch.models.dfnet import dfnet_params_to_jax, init_dfnet_params
from dfnet_tpu_torch.models.factory import create_nerfh
from dfnet_tpu_torch.training.checkpoints import load_pytree, save_pytree

# the stage-2 synthetic command of .claude/skills/verify/SKILL.md
STAGE2 = ["--dataset_type", "synthetic", "--NeRFH", "--encode_hist",
          "--netdepth", "2", "--netwidth", "32", "--netdepth_fine", "2",
          "--netwidth_fine", "32", "--N_samples", "16", "--N_importance", "16",
          "--expname", "nerfh", "--model_name", "dfnet", "--DFNet",
          "--featurenet_batch_size", "2", "--tripletloss", "--tinyimg",
          "--epochs", "2", "--i_eval", "2"]
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


@pytest.fixture
def base(tmp_path):
    """A basedir holding a stage-1 checkpoint of the command's NeRF."""
    cfg = parse_args(STAGE2 + ["--device", "cpu"])
    _, params = create_nerfh(cfg, torch.Generator().manual_seed(3))
    save_pytree(str(tmp_path / "nerfh" / "000005.npz"), {"params": params}, global_step=5)
    return tmp_path


def test_stage2_command_trains_and_prints_median_error(base, capsys):
    err = cli.train(STAGE2 + ["--basedir", str(base), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[FrozenNeRF] loaded" in out and "renders RVS" not in out
    assert len(re.findall(r"At epoch +\d+ : train loss", out)) == 3
    medians = MEDIAN.findall(out)
    assert len(medians) == 2               # epochs 0 and 2
    np.testing.assert_allclose([float(v) for v in medians[-1]], err[0], rtol=1e-12)
    saved = sorted(os.listdir(base / "dfnet"))
    assert saved[0].startswith("checkpoint-0000-") and "metrics.jsonl" in saved
    tree, _ = load_pytree(str(base / "dfnet" / saved[0]))
    assert tree["params"]["encoder"]["conv1_1"]["w"].shape == (3, 3, 3, 64)   # JAX layout
    assert set(tree["state"]["adapt"]) == {"0", "1", "2"}
    assert os.path.exists(base / "nerfh" / "args.txt")


def test_eval_of_a_jax_checkpoint_gives_jax_median_error(base, capsys):
    params, state = jax_init_dfnet(jax.random.PRNGKey(4))
    ckpt = str(base / "jax_dfnet.npz")
    jax_save_pytree(ckpt, {"params": params, "state": state})
    argv = STAGE2 + ["--basedir", str(base), "--eval", "--pretrain_model_path", ckpt]
    med, mean = cli.train(argv + ["--device", "cpu"])
    scene = load_scene(parse_args(argv + ["--device", "cpu"], stage="feature"))
    from test_torch_port_feature import _jax_scene

    jt = JaxFeatureTrainer(jax_parse_args(argv, stage="feature"), _jax_scene(scene), None)
    jmed, jmean = jt.eval_median_error()
    np.testing.assert_allclose(med, jmed, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mean, jmean, rtol=1e-4, atol=1e-5)
    assert len(MEDIAN.findall(capsys.readouterr().out)) == 2
    assert os.listdir(base / "dfnet") == []          # --eval trains and saves nothing


@pytest.mark.parametrize("flags, item", [
    (["--render_feature_only"], "item 6"),
    (["--pretrain_model_path", "dfnet.pt"], "item 7"),
    (["--vgg_init_path", "vgg16.pth"], "item 7"),
    (["--mesh_shape", "0"], "item 10"),
])
def test_unported_flags_refuse(base, flags, item, monkeypatch, capsys):
    """A mesh the device cannot hold refuses before anything is written:
    --mesh_shape 0 means every local GPU, and on the CPU it raises
    ValueError (the mesh itself, ROADMAP.md Queue 1 item 10, runs: tests/
    test_torch_port_mesh_cli.py). The flags of items 6 and 7 run:
    --render_feature_only writes the saliency maps of every train view
    and its render under ./tmp/features; --eval of a reference .pt prints
    the median error of the .npz it was exported from; --vgg_init_path
    starts the encoder from a torchvision VGG16 state dict and trains."""
    argv = STAGE2 + ["--basedir", str(base), "--device", "cpu"]
    if item == "item 10":
        with pytest.raises(ValueError, match="mesh_shape 0 means every local GPU"):
            cli.train(argv + flags)
        assert not os.path.exists(base / "dfnet")
        return
    if flags[0] == "--render_feature_only":
        monkeypatch.chdir(base)
        assert cli.train(argv + flags) is None
        for sub in ("target", "rgb"):
            assert sorted(os.listdir(base / "tmp" / "features" / sub)) == \
                [f"{i:04d}.png" for i in range(12)]
        assert "render features done" in capsys.readouterr().out
    elif flags[0] == "--pretrain_model_path":
        p, s = init_dfnet_params(torch.Generator().manual_seed(8))
        npz, pt = str(base / "dfnet.npz"), str(base / flags[1])
        save_pytree(npz, dict(zip(("params", "state"), dfnet_params_to_jax(p, s))))
        export_dfnet_checkpoint(p, s, pt)
        want = cli.train(argv + ["--eval", "--pretrain_model_path", npz])
        got = cli.train(argv + ["--eval", "--pretrain_model_path", pt])
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert MEDIAN.findall(capsys.readouterr().out)[-1] == tuple(str(v) for v in got[0])
    else:
        from test_torch_port_convert import _vgg16_state_dict

        torch.save(_vgg16_state_dict(), str(base / flags[1]))
        cli.train(argv + ["--vgg_init_path", str(base / flags[1]), "--epochs", "0"])
        out = capsys.readouterr().out
        assert f"ImageNet VGG16 init from {base / flags[1]}" in out
        assert len(re.findall(r"At epoch +\d+ : train loss", out)) == 1
        assert any(f.startswith("checkpoint-0000-") for f in os.listdir(base / "dfnet"))


def test_no_gpu_raises_without_device_cpu(base):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.train(STAGE2 + ["--basedir", str(base)])
