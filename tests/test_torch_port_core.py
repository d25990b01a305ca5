"""Port modules against their dfnet_tpu counterparts on the CPU: the same
numpy inputs (from a seed) go through both packages. Tolerances are
float32 round-off unless stated."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import dataclasses
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfnet_tpu import config as jcfg
from dfnet_tpu.data.synthetic import make_synthetic_scene as jax_scene
from dfnet_tpu.models import nerfw as jnerfw
from dfnet_tpu.models.embedder import get_embedder as jax_embedder
from dfnet_tpu.render import fast as jfast
from dfnet_tpu.render import sampling as jsampling
from dfnet_tpu_torch import config as tcfg
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.models import nerfw as tnerfw
from dfnet_tpu_torch.models.embedder import get_embedder
from dfnet_tpu_torch.render import fast as tfast
from dfnet_tpu_torch.render import sampling as tsampling
from dfnet_tpu_torch.training.checkpoints import params_from_numpy


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("F", [10, 4])
def test_embedder(F):
    rng = np.random.default_rng(F)
    x = rng.uniform(-1.5, 1.5, (5, 7, 3)).astype(np.float32)
    want = _np(jax_embedder(F)(jnp.asarray(x)))
    got = get_embedder(F)(_t(x)).numpy()
    assert got.shape == want.shape == (5, 7, 6 * F + 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def _mlp(D, W, skips, fine, seed=0):
    cfg = jnerfw.NeRFWConfig(D=D, W=W, skips=skips, in_xyz=63, in_dir=27,
                             encode_appearance=fine, encode_transient=fine)
    jp = jnerfw.init_nerfw_params(jax.random.PRNGKey(seed), cfg)
    tcfg_ = tnerfw.NeRFWConfig(D=D, W=W, skips=skips, in_xyz=63, in_dir=27,
                               encode_appearance=fine, encode_transient=fine)
    return cfg, jp, tcfg_, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("sigma_only", [True, False])
def test_nerfw_apply_rays(sigma_only):
    cfg, jp, tc, tp = _mlp(4, 64, (2,), fine=True)
    rng = np.random.default_rng(1)
    N, S = 6, 5
    xyz = rng.normal(size=(N, S, 63)).astype(np.float32)
    d = rng.normal(size=(N, 27)).astype(np.float32)
    a = rng.normal(size=(N, 50)).astype(np.float32)
    t = rng.normal(size=(N, 20)).astype(np.float32)
    if sigma_only:
        want = jnerfw.nerfw_apply_rays(jp, cfg, jnp.asarray(xyz), sigma_only=True)
        got = tnerfw.nerfw_apply_rays(tp, tc, _t(xyz), sigma_only=True)
    else:
        want = jnerfw.nerfw_apply_rays(jp, cfg, *map(jnp.asarray, (xyz, d, a, t)),
                                       output_transient=True)
        got = tnerfw.nerfw_apply_rays(tp, tc, *map(_t, (xyz, d, a, t)),
                                      output_transient=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


def test_stratified_and_sample_pdf_det():
    rng = np.random.default_rng(2)
    N = 8
    near = np.full((N, 1), 0.5, np.float32)
    far = np.full((N, 1), 3.5, np.float32)
    for lindisp in (False, True):
        want = _np(jsampling.stratified_z_vals(jnp.asarray(near), jnp.asarray(far),
                                               32, None, lindisp, 0.0))
        got = tsampling.stratified_z_vals(_t(near), _t(far), 32, None,
                                          lindisp, 0.0).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    z = want
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    w = (rng.uniform(size=(N, 30)) ** 4).astype(np.float32)
    want = _np(jsampling.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 48, det=True))
    got = tsampling.sample_pdf(_t(bins), _t(w), 48, det=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _placement(N=16, M=63, seed=3):
    rng = np.random.default_rng(seed)
    bins = np.broadcast_to(np.linspace(0.5, 3.5, M + 1, dtype=np.float32),
                           (N, M + 1)).copy()
    # peaked weights, like a trained density along each ray
    c = rng.uniform(10, 50, (N, 1))
    w = np.exp(-0.5 * ((np.arange(M)[None] - c) / 3.0) ** 2).astype(np.float32)
    return bins, w


def test_sample_pdf_blend():
    bins, w = _placement()
    want = _np(jfast.sample_pdf_blend(jnp.asarray(bins), jnp.asarray(w), 96, 1 / 3))
    got = tsampling.sample_pdf_blend(_t(bins), _t(w), 96, 1 / 3).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert (np.diff(got, axis=-1) >= -1e-6).all()


def test_sample_pdf_culled():
    bins, w = _placement(seed=4)
    want = _np(jfast.sample_pdf_culled(jnp.asarray(bins), jnp.asarray(w),
                                       24, lam=0.5, q=2e-3))
    got = tsampling.sample_pdf_culled(_t(bins), _t(w), 24, lam=0.5,
                                  q=2e-3).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert (np.diff(got, axis=-1) >= -1e-6).all()


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_composite_soa(white_bkgd):
    rng = np.random.default_rng(5)
    N, S = 12, 40
    raw = rng.normal(size=(9, N, S)).astype(np.float32) * 2
    z = np.sort(rng.uniform(0.5, 3.5, (N, S)), -1).astype(np.float32)
    raw16 = np.concatenate([raw, np.zeros((7, N, S), np.float32)])
    want = jfast.composite_soa(jnp.asarray(raw16), jnp.asarray(z), white_bkgd)
    got = tfast.composite_soa(_t(raw), _t(z), white_bkgd)
    for k in ("rgb", "disp", "acc", "depth", "rgb_static_only"):
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def test_get_rays():
    from dfnet_tpu.render import rays as jrays
    from dfnet_tpu_torch.render import rays as trays

    rng = np.random.default_rng(7)
    c2w = np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0],
                          rng.normal(size=(3, 1))], -1).astype(np.float32)
    want = jrays.get_rays(6, 8, 7.5, jnp.asarray(c2w))
    got = trays.get_rays(6, 8, 7.5, _t(c2w))
    want_np = jrays.get_rays_np(6, 8, 7.5, c2w)
    got_np = trays.get_rays_np(6, 8, 7.5, c2w)
    for g, w, g_np, w_np in zip(got, want, got_np, want_np):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(g_np, w_np)


def test_eval_losses():
    from dfnet_tpu.models import losses as jlosses
    from dfnet_tpu_torch.models import losses as tlosses

    rng = np.random.default_rng(6)
    x = rng.uniform(-0.1, 1.1, (4, 5, 3)).astype(np.float32)
    y = rng.uniform(0.0, 1.0, (4, 5, 3)).astype(np.float32)
    mse_j = jlosses.img2mse(jnp.asarray(x), jnp.asarray(y))
    mse_t = tlosses.img2mse(_t(x), _t(y))
    np.testing.assert_allclose(mse_t.numpy(), _np(mse_j), rtol=1e-6)
    np.testing.assert_allclose(tlosses.mse2psnr(mse_t).numpy(),
                               _np(jlosses.mse2psnr(mse_j)), rtol=1e-6)
    np.testing.assert_array_equal(tlosses.to8b(_t(x)), _np(jlosses.to8b(x)))


def test_make_synthetic_scene_bit_exact():
    kw = dict(n_train=3, n_val=2, H=12, W=16, focal=15.0, seed=7,
              appearance_jitter=0.1)
    a, b = make_synthetic_scene(**kw), jax_scene(**kw)
    for split in ("train", "val"):
        for f in ("images", "poses", "hists", "gt_idx"):
            x, y = getattr(getattr(a, split), f), getattr(getattr(b, split), f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert (a.hwf, a.near, a.far, a.world_setup) == (b.hwf, b.near, b.far,
                                                     b.world_setup)


@pytest.mark.parametrize("path", sorted(glob.glob("configs/*.txt")))
def test_configs_parse_equal(path):
    j = dataclasses.asdict(jcfg.parse_args(["--config", path], stage="nerf"))
    t = dataclasses.asdict(tcfg.parse_args(["--config", path], stage="nerf"))
    assert t.pop("device") == "cuda"
    assert t == j
