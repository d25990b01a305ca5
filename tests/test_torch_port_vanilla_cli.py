"""The vanilla NeRF's CLIs (NeRFH=False), port against dfnet_tpu on the CPU:
each package's stage-1 checkpoint in the other and their --render_test
PSNRs (within 0.1 dB, PERF.md section 2's render bar), the spiral and the
videos, stage 2 with --NeRFH False (its pre-render against JAX's
FrozenNeRF at 1e-4), and the three places where the JAX package fails on a
vanilla NeRF (stage 3, a `.tar` load, render_fn_batch), where the port
raises NotImplementedError instead. The models themselves are held in
tests/test_torch_port_vanilla.py."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import contextlib
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfnet_tpu.cli import dm as jax_dm_cli
from dfnet_tpu.cli import nerf as jax_nerf_cli
from dfnet_tpu.config import parse_args as jax_parse_args
from dfnet_tpu.models import nerf_vanilla as jnv
from dfnet_tpu.training.dm_trainer import DMTrainer as JaxDMTrainer
from dfnet_tpu.training.nerf_renderer import FrozenNeRF as JaxFrozenNeRF
from dfnet_tpu_torch.cli import dm as dm_cli
from dfnet_tpu_torch.cli import feature as feature_cli
from dfnet_tpu_torch.cli import nerf as nerf_cli
from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.loader import load_scene
from dfnet_tpu_torch.data.png import read_apng
from dfnet_tpu_torch.training.checkpoints import load_pytree
from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF

NEAR, FAR = 0.5, 3.5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes gain nothing from intra-op threads, and test workers that
    each run a thread a core slow one another down: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S1 = ["--dataset_type", "synthetic", "--netdepth", "2", "--netwidth", "16",
      "--netdepth_fine", "2", "--netwidth_fine", "16", "--N_samples", "6",
      "--N_importance", "6", "--N_rand", "64", "--expname", "nerf"]
S2 = ["--dataset_type", "synthetic", "--NeRFH", "False", "--encode_hist",
      "--netdepth", "2", "--netwidth", "16", "--netdepth_fine", "2",
      "--netwidth_fine", "16", "--N_samples", "6", "--N_importance", "6",
      "--expname", "nerf", "--model_name", "dfnet", "--DFNet",
      "--featurenet_batch_size", "2", "--tripletloss", "--tinyimg", "--epochs", "0",
      "--i_eval", "1"]
WORLD = {"pose_scale": 0.8, "pose_scale2": 1.25, "move_all_cam_vec": [0.1, -0.05, 0.2]}
PSNR = re.compile(r"Mean PSNR of this run is: (\S+)")


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """Two basedirs: one where the JAX CLI trained stage 1 for two epochs,
    one where the port's did."""
    jbase, tbase = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    train = ["--epochs", "2", "--i_weights", "2", "--i_testset", "100"]
    jax_nerf_cli.train(S1 + train + ["--basedir", str(jbase)])
    nerf_cli.train(S1 + train + ["--basedir", str(tbase), "--device", "cpu"])
    return jbase, tbase


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_and_render_test_psnrs_agree(stage1, writer, capsys):
    """Each package's `.npz` resumes in the other (the vanilla tree under
    JAX's names), and --render_test of it gives the same val PSNR."""
    base = stage1[0] if writer == "jax" else stage1[1]
    tree, _ = load_pytree(str(base / "nerf" / "000002.npz"))
    assert sorted(tree["params"]) == ["coarse", "fine"]
    assert sorted(tree["params"]["fine"]) == ["alpha", "feature", "pts_0", "pts_1", "rgb",
                                              "views_0"]
    argv = S1 + ["--basedir", str(base), "--render_test"]
    p_port = nerf_cli.train(argv + ["--device", "cpu"])
    p_jax = jax_nerf_cli.train(argv)
    out = capsys.readouterr().out
    assert out.count("resumed from") == 2 and "cold" not in out
    assert np.isfinite(p_port) and abs(p_port - float(p_jax)) < 0.1, (p_port, p_jax)


def test_spiral_and_videos_of_a_vanilla_nerf(stage1):
    """--render_pose_only and --render_video_test over the port's vanilla
    checkpoint: the 120-frame spiral and the val split's two videos."""
    base = stage1[1]
    nerf_cli.train(S1 + ["--basedir", str(base), "--render_pose_only", "--device", "cpu"])
    frames = read_apng(str(base / "nerf" / "spiral_000003.png"))
    assert len(frames) == 120 and frames[0].shape == (48, 64, 3)
    nerf_cli.train(S1 + ["--basedir", str(base), "--render_test", "--render_video_test",
                         "--device", "cpu"])
    for kind in ("rgb", "disp"):
        assert len(read_apng(str(base / "nerf" / f"nerf_test_000003_test_{kind}.png"))) == 4


@pytest.fixture(scope="module")
def stage2(stage1):
    """The port's stage-2 CLI with --NeRFH False, one epoch on the port's
    stage-1 checkpoint: (argv, printed output)."""
    argv = S2 + ["--basedir", str(stage1[1])]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        feature_cli.train(argv + ["--device", "cpu"])
    return argv, buf.getvalue()


def test_stage2_with_nerfh_false_trains_and_prerenders_as_jax(stage2):
    argv, out = stage2
    losses = re.findall(r"train loss: (\S+), val loss: (\S+)", out)
    assert len(losses) == 1 and np.isfinite(np.asarray(losses, float)).all()
    assert "[FrozenNeRF] loaded" in out
    cfg = parse_args(argv + ["--device", "cpu"], stage="feature")
    scene = load_scene(cfg)
    nerf = FrozenNeRF.from_experiment(cfg, scene.hwf, scene.near, scene.far, WORLD)
    jnerf = JaxFrozenNeRF.from_experiment(jax_parse_args(argv, stage="feature"), scene.hwf,
                                          scene.near, scene.far, WORLD)
    assert nerf.is_vanilla and not nerf.uses_fast_render
    pose, hist = scene.train.poses[1], scene.train.hists[1]
    got = nerf.prerender_views(pose[None], hist[None], log_every=0)[0]
    want = np.asarray(jnerf.render_at_pose(pose, hist))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_stage3_over_a_vanilla_nerf_refuses_where_jax_fails(stage1, stage2):
    ckpt = sorted((stage1[1] / "dfnet").glob("checkpoint-*.npz"))[0]
    argv = [a for a in stage2[0] if a != "--tripletloss"] + [
        "--model_name", "dfnetdm", "--pretrain_model_path", str(ckpt), "--N_rand", "64",
        "--combine_loss_w", "[0., 0., 1.]", "--combine_loss"]
    with pytest.raises(NotImplementedError, match="dm_trainer.py:211-215"):
        dm_cli.train(argv + ["--device", "cpu"])
    jcfg = jax_parse_args(argv, stage="dm")
    scene, jnerf = jax_dm_cli._setup(jcfg)
    with pytest.raises(KeyError):
        JaxDMTrainer(jcfg, scene, jnerf).eval_epoch()


def _vanilla_tar(path, params):
    """A reference vanilla-NeRF `.tar`: network_{fn,fine}_state_dict under
    the reference's layer names."""
    def sd(p):
        names = {"feature": "feature_linear", "alpha": "alpha_linear",
                 "views_0": "views_linears.0", "rgb": "rgb_linear"}
        out = {}
        for k, v in p.items():
            name = names.get(k) or f"pts_linears.{k.split('_')[1]}"
            out[f"{name}.weight"] = torch.tensor(np.asarray(v["w"]).T.copy())
            out[f"{name}.bias"] = torch.tensor(np.asarray(v["b"]))
        return out

    torch.save({"global_step": 2, "network_fn_state_dict": sd(params["coarse"]),
                "network_fine_state_dict": sd(params["fine"])}, path)


def test_tar_load_and_render_fn_batch_refuse_where_jax_fails(stage1, tmp_path):
    tbase = stage1[1]
    tree, _ = load_pytree(str(tbase / "nerf" / "000002.npz"))
    tar = str(tmp_path / "000002.tar")
    _vanilla_tar(tar, tree["params"])
    assert jnv.vanilla_state_dict_to_params(torch.load(tar)["network_fn_state_dict"], D=2)
    argv = S2 + ["--basedir", str(tbase)]
    cfg = parse_args(argv + ["--device", "cpu"], stage="feature")
    jcfg = jax_parse_args(argv, stage="feature")
    hwf = (12, 16, 15.0)
    nerf = FrozenNeRF(cfg, hwf, NEAR, FAR, WORLD)
    jnerf = JaxFrozenNeRF(jcfg, hwf, NEAR, FAR, WORLD)
    with pytest.raises(NotImplementedError, match="convert.py:54-72"):
        nerf.load(tar)
    with pytest.raises(KeyError):
        jnerf.load(tar)
    poses = np.stack([np.eye(4, dtype=np.float32)[:3]] * 2)
    hists = np.zeros((2, 10), np.int32)
    with pytest.raises(NotImplementedError, match="nerf_renderer.py:141-166"):
        nerf.render_fn_batch(nerf.params, torch.tensor(poses), torch.tensor(hists))
    with pytest.raises(KeyError):
        jnerf.render_fn_batch(jnerf.params, jnp.asarray(poses), jnp.asarray(hists))
