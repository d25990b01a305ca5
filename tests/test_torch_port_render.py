"""The render slice as a whole, port against dfnet_tpu on the CPU: the
kernel render path (plain kernel versions) against the JAX fast path in
interpret mode, the plain renderers against each other, and the val PSNR
of the trained asset. The JAX val PSNR of the stage-1 CLI's --render_test
is the figure chip_smoke.py holds the port's GPU run to."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dfnet_tpu.config import parse_args as jax_parse_args
from dfnet_tpu.data.synthetic import make_synthetic_scene as jax_scene
from dfnet_tpu.models.factory import create_nerfh as jax_create_nerfh
from dfnet_tpu.models.factory import render_settings as jax_render_settings
from dfnet_tpu.render.fast import render_image_fast as jax_render_image_fast
from dfnet_tpu.render.volume import render_image as jax_render_image
from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.models.factory import create_nerfh, render_settings
from dfnet_tpu_torch.render.fast import kernels_serve, render_image_fast
from dfnet_tpu_torch.render.volume import render_image
from dfnet_tpu_torch.training.checkpoints import params_from_numpy

SMALL = ["--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
         "--netdepth", "6", "--netwidth", "32", "--netdepth_fine", "6",
         "--netwidth_fine", "32", "--N_samples", "16", "--N_importance", "16"]


@pytest.fixture(scope="module")
def small():
    jcfg = jax_parse_args(SMALL, stage="nerf")
    jmodel, jparams = jax_create_nerfh(jcfg, jax.random.PRNGKey(0))
    cfg = parse_args(SMALL + ["--device", "cpu"], stage="nerf")
    model, _ = create_nerfh(cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    c2w = np.concatenate([np.eye(3), [[0.1], [0.0], [1.2]]], -1).astype(np.float32)
    hist = np.random.default_rng(0).integers(0, 20, 10).astype(np.int32)
    return jcfg, jmodel, jparams, cfg, model, params, c2w, hist


def test_render_image_fast_matches_jax_interpret(small):
    jcfg, jmodel, jparams, cfg, model, params, c2w, hist = small
    st_j = jax_render_settings(jcfg, 0.5, 3.5, test=True)
    st = render_settings(cfg, 0.5, 3.5, test=True)
    assert kernels_serve(model, st)
    H, W, focal = 6, 8, 8.0
    want = jax_render_image_fast(jparams, jmodel, jnp.asarray(c2w),
                                 jnp.asarray(hist), H, W, focal, st_j,
                                 chunk=64, interpret=True)
    got = render_image_fast(params, model, torch.tensor(c2w), torch.tensor(hist),
                            H, W, focal, st, chunk=20)     # ragged last chunk
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]),
                               atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(got["acc"].numpy(), np.asarray(want["acc"]),
                               atol=3e-2, rtol=3e-2)


def test_render_image_matches_jax(small):
    jcfg, jmodel, jparams, cfg, model, params, c2w, hist = small
    st_j = jax_render_settings(jcfg, 0.5, 3.5, test=True)
    st = render_settings(cfg, 0.5, 3.5, test=True)
    H, W, focal = 6, 8, 8.0
    want = jax_render_image(jparams, jmodel, jnp.asarray(c2w), jnp.asarray(hist),
                            H, W, focal, st_j, chunk=32)
    got = render_image(params, model, torch.tensor(c2w), torch.tensor(hist),
                       H, W, focal, st, chunk=32)
    for k in ("rgb", "disp", "acc"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)


def test_trained_asset_val_psnr_matches_jax():
    """The stage-1 CLI's val split (synthetic, seed 0, 48x64) on the trained
    W=128 asset: JAX's plain float32 render gives chip_smoke.JAX_VAL_PSNR;
    the port's kernel path (plain versions here) is within 0.05 dB of JAX
    on two views."""
    from dfnet_tpu.training.nerf_trainer import NeRFTrainer as JaxTrainer
    from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer

    argv = ["--NeRFH", "--encode_hist", "--dataset_type", "synthetic"]
    jcfg = jax_parse_args(argv, stage="nerf")
    jscene = jax_scene(H=48, W=64, focal=60.0, seed=0)
    jtr = JaxTrainer(jcfg, jscene)
    jtr.load_params("assets/nerfh_synthetic_301.npz")
    jtr.params = jax.tree.map(jnp.asarray, jtr.params)
    # per-view PSNRs exactly as render_split computes them, in one dispatch
    out = jtr._render_views(jtr.params, jnp.asarray(jscene.val.poses),
                            jnp.asarray(jscene.val.hists), jnp.float32(301))
    rgb = np.asarray(out["rgb"])
    psnr = [-10.0 * np.log10(np.mean(np.square(rgb[i] - jscene.val.images[i])))
            for i in range(len(jscene.val))]
    assert abs(float(np.mean(psnr)) - chip_smoke.JAX_VAL_PSNR) < 5e-3
    jax_two = float(np.mean(psnr[:2]))

    cfg = parse_args(argv + ["--device", "cpu"], stage="nerf")
    scene = make_synthetic_scene(H=48, W=64, focal=60.0, seed=0)
    tr = NeRFTrainer(cfg, scene)
    assert tr.uses_fast_render
    tr.load_params("assets/nerfh_synthetic_301.npz")
    assert tr.global_step == 301
    port_two = tr.render_split(scene.val, max_images=2)
    assert abs(port_two - jax_two) < 0.05, (port_two, jax_two)

