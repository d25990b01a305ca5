"""The frozen-NeRF render service, port against dfnet_tpu on the CPU: both
packages' FrozenNeRF load the same JAX-written checkpoint through
from_experiment and render the synthetic scene's views under a
non-identity world setup. The port's no-grad renders take its kernel path
(plain versions here); JAX's are gated to its plain renderer on the CPU
(dfnet_tpu/render/fast.py:464). Tolerances: renders 3e-2 (the kernel
path's bar, tests/test_fast_render.py:119), pose gradients 3e-2 of their
scale, the resizes 1e-5."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfnet_tpu.config import parse_args as jax_parse_args
from dfnet_tpu.convert import export_nerf_checkpoint as jax_export_nerf
from dfnet_tpu.data.synthetic import make_synthetic_scene as jax_scene
from dfnet_tpu.models.factory import create_nerfh as jax_create_nerfh
from dfnet_tpu.ops.resize import resize_bicubic as jax_bicubic
from dfnet_tpu.ops.resize import resize_bilinear_align_corners as jax_bilinear
from dfnet_tpu.pose import rescale_poses_to_nerf as jax_rescale
from dfnet_tpu.training.checkpoints import load_pytree as jax_load_pytree
from dfnet_tpu.training.checkpoints import save_pytree as jax_save_pytree
from dfnet_tpu.training.nerf_renderer import FrozenNeRF as JaxFrozenNeRF
from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.ops.resize import resize_bicubic, resize_bilinear_align_corners
from dfnet_tpu_torch.parallel.mesh import Mesh
from dfnet_tpu_torch.pose.se3 import rescale_poses_to_nerf
from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF

SMALL = ["--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
         "--netdepth", "2", "--netwidth", "32", "--netdepth_fine", "2",
         "--netwidth_fine", "32", "--N_samples", "16", "--N_importance", "16",
         "--expname", "nerfh", "--tinyscale", "2"]
WORLD = {"pose_scale": 0.8, "pose_scale2": 1.25, "move_all_cam_vec": [0.1, -0.05, 0.2]}
TOL = 3e-2


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """A basedir holding one JAX-written stage-1 checkpoint, and the scene."""
    base = tmp_path_factory.mktemp("frozen")
    jcfg = jax_parse_args(SMALL + ["--basedir", str(base)], stage="nerf")
    _, jparams = jax_create_nerfh(jcfg, jax.random.PRNGKey(0))
    jax_save_pytree(str(base / "nerfh" / "000005.npz"), {"params": jparams},
                    global_step=5)
    return base, jax_scene(n_train=1, n_val=10, H=12, W=16, focal=15.0, seed=0)


def _pair(exp, *flags):
    base, sc = exp
    argv = SMALL + ["--basedir", str(base), *flags]
    jnerf = JaxFrozenNeRF.from_experiment(jax_parse_args(argv, stage="nerf"), sc.hwf,
                                          sc.near, sc.far, WORLD)
    nerf = FrozenNeRF.from_experiment(parse_args(argv + ["--device", "cpu"], stage="nerf"),
                                      sc.hwf, sc.near, sc.far, WORLD)
    return jnerf, nerf


@pytest.mark.parametrize("tiny", [False, True])
def test_render_at_pose_matches_jax(exp, tiny, capsys):
    jnerf, nerf = _pair(exp, *(["--tinyimg"] if tiny else []))
    assert "loaded" in capsys.readouterr().out
    assert nerf.uses_fast_render
    sc = exp[1]
    for i in (0, 3):
        want = np.asarray(jnerf.render_at_pose(sc.val.poses[i], sc.val.hists[i]))
        got = nerf.render_at_pose(sc.val.poses[i], sc.val.hists[i])
        assert got.shape == (12, 16, 3) and not got.requires_grad
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("tiny", [False, True])
def test_pose_grad_through_render_fn_matches_jax(exp, tiny):
    """d(photometric loss)/d(pose) through the plain renderer (and the
    bicubic upsample under tinyimg), against jax.grad."""
    jnerf, nerf = _pair(exp, *(["--tinyimg"] if tiny else []))
    sc = exp[1]
    pose, hist, target = sc.val.poses[2], sc.val.hists[2], sc.val.images[5]

    def jloss(p):
        return jnp.mean((jnerf.render_fn(jnerf.params, p, jnp.asarray(hist))
                         - target) ** 2)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(pose)))
    p = torch.tensor(pose, requires_grad=True)
    loss = torch.mean((nerf.render_fn(nerf.params, p, torch.tensor(hist))
                       - torch.tensor(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss(jnp.asarray(pose))), rtol=1e-4)
    got = p.grad.numpy()
    scale = np.abs(want).max()
    assert scale > 1e-6 and np.abs(got).max() > 1e-6
    assert np.abs(got - want).max() <= TOL * scale, (got, want)


def test_render_fn_batch_matches_render_fn(exp):
    _, nerf = _pair(exp, "--tinyimg")
    sc = exp[1]
    poses = torch.tensor(sc.val.poses[:3], requires_grad=True)
    hists = torch.tensor(sc.val.hists[:3])
    batch = nerf.render_fn_batch(nerf.params, poses, hists)
    assert batch.shape == (3, 12, 16, 3)
    for i in range(3):
        one = nerf.render_fn(nerf.params, poses[i], hists[i])
        torch.testing.assert_close(batch[i], one, atol=1e-5, rtol=1e-5)
    batch.sum().backward()
    assert torch.isfinite(poses.grad).all() and poses.grad.abs().max() > 0


@pytest.mark.parametrize("tiny", [False, True])
def test_prerender_views_matches_jax(exp, tiny, capsys):
    jnerf, nerf = _pair(exp, *(["--tinyimg"] if tiny else []))
    sc = exp[1]
    assert len(sc.val) == 10                         # pads the second call by 6
    want = jnerf.prerender_views(sc.val.poses, sc.val.hists)
    got = nerf.prerender_views(sc.val.poses, sc.val.hists)
    assert got.shape == (10, 12, 16, 3) and got.dtype == np.float32
    assert "renders 0/total 10" in capsys.readouterr().out
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    last = nerf.render_at_pose(sc.val.poses[-1], sc.val.hists[-1]).numpy()
    np.testing.assert_array_equal(got[-1], last)


def test_frozen_nerf_refuses_what_is_not_ported(exp, tmp_path, capsys):
    """Without a checkpoint: random weights and a warning. A reference .tar
    loads (the JAX checkpoint's coarse and fine nets and embeddings,
    exported by JAX's converter; no proposal net). A device mesh is taken
    (ROADMAP.md, Queue 1 item 10): outside a process group its helpers are
    the identity, so the render is the meshless one bit for bit (the mesh's
    own renders: tests/test_torch_port_mesh.py)."""
    base, sc = exp
    cfg = parse_args(SMALL + ["--basedir", str(tmp_path), "--device", "cpu"],
                     stage="nerf")
    nerf = FrozenNeRF.from_experiment(cfg, sc.hwf, sc.near, sc.far, WORLD)
    assert "random weights" in capsys.readouterr().out
    tree, _ = jax_load_pytree(str(base / "nerfh" / "000005.npz"))
    jax_export_nerf(tree["params"], str(tmp_path / "000001.tar"), 5)
    nerf.load(str(tmp_path / "000001.tar"))
    assert sorted(nerf.params) == ["coarse", "embedding_a", "embedding_t", "fine"]
    for k in ("coarse", "fine"):
        for layer, p in tree["params"][k].items():
            for leaf, v in p.items():
                np.testing.assert_array_equal(nerf.params[k][layer][leaf].numpy(), v)
    meshed = FrozenNeRF(cfg, sc.hwf, sc.near, sc.far, WORLD, params=nerf.params,
                        mesh=Mesh(2, "cpu"))
    assert meshed.mesh == Mesh(2, "cpu") and meshed.device.type == "cpu"
    np.testing.assert_array_equal(meshed.render_at_pose(sc.val.poses[0], sc.val.hists[0]),
                                  nerf.render_at_pose(sc.val.poses[0], sc.val.hists[0]))


@pytest.mark.parametrize("shape,out", [
    ((2, 6, 8, 3), (12, 16)),        # the tinyimg upsample, x2
    ((12, 16, 3), (48, 64)),         # x4, no batch axis
    ((3, 9, 5, 2), (4, 11)),         # down in H, up in W
    ((1, 5, 7, 4), (5, 7)),          # same size
])
def test_resizes_match_jax(shape, out):
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    for port, ref in ((resize_bicubic, jax_bicubic),
                      (resize_bilinear_align_corners, jax_bilinear)):
        got = port(torch.tensor(x), *out)
        assert got.shape == shape[:-3] + out + shape[-1:]
        np.testing.assert_allclose(got.numpy(), np.asarray(ref(jnp.asarray(x), *out)),
                                   atol=1e-5, rtol=1e-5, err_msg=port.__name__)


def test_bicubic_is_differentiable():
    x = torch.tensor(np.random.default_rng(0).normal(size=(6, 8, 3)).astype(np.float32),
                     requires_grad=True)
    resize_bicubic(x, 12, 16).sum().backward()
    # each input pixel's weights over the x2 upsample sum to 4 away from the border
    np.testing.assert_allclose(x.grad[2:-2, 2:-2].numpy(), 4.0, atol=1e-5)


def test_rescale_poses_matches_jax():
    poses = np.random.default_rng(1).normal(size=(4, 3, 4)).astype(np.float32)
    want = np.asarray(jax_rescale(jnp.asarray(poses), 0.8, [0.1, -0.05, 0.2], 1.25))
    np.testing.assert_allclose(rescale_poses_to_nerf(poses, 0.8, [0.1, -0.05, 0.2], 1.25),
                               want, atol=1e-6)
    np.testing.assert_allclose(jax_rescale(poses, 0.8, [0.1, -0.05, 0.2], 1.25), want,
                               atol=1e-6)
    p = torch.tensor(poses, requires_grad=True)
    out = rescale_poses_to_nerf(p, 0.8, [0.1, -0.05, 0.2], 1.25)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-6)
    out.sum().backward()
    g = np.ones((4, 3, 4), np.float32)
    g[..., 3] = 0.8 * 1.25
    np.testing.assert_allclose(p.grad.numpy(), g, atol=1e-6)
    assert not np.shares_memory(rescale_poses_to_nerf(poses, 1.0, [0, 0, 0], 1.0), poses)
