"""The windowed positional encoding (--reduce_embedding 2), port against
dfnet_tpu on the CPU.

Under --reduce_embedding 2 the xyz and direction embedders are windowed
(Nerfie Eq. 8): frequency j is scaled by a window that opens with the
epoch, alpha = F * epoch / epochToMaxFreq. JAX hands the epoch to the
embedders in the stage-1 loss and in the eval renders
(dfnet_tpu/training/nerf_trainer.py:137-152, :303-307, :368-372); the
port must do the same. The kernel paths refuse a windowed embedder, so
these renders are the plain ones.

Same seeded numpy params and rays in both packages, perturb 0 and no
sigma noise, float32 matmuls. Bars as in tests/test_torch_port_train.py:
rendered rgb within 3e-2, the loss within rtol 1e-3, every grad within
3e-2 * scale + 1e-7 (scale: the leaf's largest magnitude)."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfnet_tpu.config import parse_args as jax_parse_args
from dfnet_tpu.models import nerfw as jnerfw
from dfnet_tpu.models.factory import create_nerfh as jax_create_nerfh
from dfnet_tpu.models.factory import render_settings as jax_render_settings
from dfnet_tpu.models.losses import img2mse as jax_img2mse
from dfnet_tpu.models.losses import nerfw_loss as jax_nerfw_loss
from dfnet_tpu.models.losses import proposal_bound_loss as jax_proposal_bound_loss
from dfnet_tpu.render.volume import composite_nerfw as jax_composite_nerfw
from dfnet_tpu.render.volume import render_rays as jax_render_rays
from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.models.embedder import Embedder
from dfnet_tpu_torch.models.factory import create_nerfh, render_settings
from dfnet_tpu_torch.render.volume import render_rays
from dfnet_tpu_torch.training.checkpoints import params_from_numpy
from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer, named_leaves, stage1_loss

NEAR, FAR = 0.5, 3.5
N_RAYS = 64
BASE = ["--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
        "--netdepth", "4", "--netwidth", "32", "--netdepth_fine", "4",
        "--netwidth_fine", "32", "--N_samples", "16", "--N_importance", "16",
        "--perturb", "0", "--raw_noise_std", "0", "--reduce_embedding", "2"]
# (epochToMaxFreq, epoch) of each window state; F = 10 (xyz) and 4 (dir)
WINDOWS = {
    "zero_default_n": (-1, 3.0),     # the default N = -1: alpha <= 0 at every epoch
    "zero_epoch_0": (8, 0.0),
    "partial": (8, 3.0),             # alpha 3.75 (xyz), 1.5 (dir)
    "full": (8, 8.0),                # alpha 10 (xyz), 4 (dir)
}


def _flat(tree):
    return {p: np.asarray(v) for p, v in named_leaves(tree)}


def _grads_close(got, want):
    """Every leaf within 3e-2 * scale + 1e-7; the number of leaves checked."""
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g, w = np.asarray(got[path], np.float64), np.asarray(w, np.float64)
        scale = max(np.abs(g).max(), np.abs(w).max(), 1e-6)
        err = np.abs(g - w).max()
        assert err < 3e-2 * scale + 1e-7, f"{path}: err {err:.2e} scale {scale:.2e}"
    return len(want)


@functools.lru_cache(maxsize=None)
def _make_case(name):
    """Both packages' models at one window state, the JAX init as numpy,
    one ray batch and its targets."""
    n_max, epoch = WINDOWS[name]
    flags = BASE + ["--epochToMaxFreq", str(n_max)]
    jcfg = jax_parse_args(flags, stage="nerf")
    jmodel, init = jax_create_nerfh(jcfg, jax.random.PRNGKey(3))
    cfg = parse_args(flags + ["--device", "cpu"], stage="nerf")
    model, _ = create_nerfh(cfg, torch.Generator().manual_seed(0), "cpu")
    assert model.embed_xyz.windowed and model.embed_dir.windowed
    rng = np.random.default_rng(11)
    ro = (rng.normal(size=(N_RAYS, 3)) * 0.3).astype(np.float32)
    rd = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    hist = np.broadcast_to(rng.integers(0, 20, (1, jcfg.hist_bin)),
                           (N_RAYS, jcfg.hist_bin)).astype(np.int32)
    target = rng.uniform(size=(N_RAYS, 3)).astype(np.float32)
    return dict(name=name, epoch=epoch, jcfg=jcfg, jmodel=jmodel,
                jst=jax_render_settings(jcfg, NEAR, FAR), cfg=cfg, model=model,
                st=render_settings(cfg, NEAR, FAR),
                params=jax.tree.map(np.asarray, init), ro=ro, rd=rd, hist=hist,
                target=target)


@pytest.fixture(params=sorted(WINDOWS))
def case(request):
    return _make_case(request.param)


def _jax_loss(c):
    """The JAX trainer's plain loss_fn (nerf_trainer.py:137-177) at this
    epoch: (loss, mse, outputs, grads)."""
    jm, jcfg = c["jmodel"], c["jcfg"]
    ro, rd, hist, target = map(jnp.asarray, (c["ro"], c["rd"], c["hist"], c["target"]))
    epoch = jnp.float32(c["epoch"])

    def loss_fn(p):
        out = jax_render_rays(p, jm, ro, rd, hist, c["jst"], jax.random.PRNGKey(0),
                              epoch=epoch)
        loss = sum(jax_nerfw_loss(out, target).values())
        z_vals = out["z_vals"]
        pts = ro[:, None, :] + rd[:, None, :] * z_vals[..., None]
        sig_p = jnerfw.nerfw_apply_rays(p["proposal"], jm.cfg_proposal,
                                        jm.embed_proposal(pts), sigma_only=True)
        comp_p = jax_composite_nerfw(sig_p, z_vals, output_transient=False,
                                     sigma_only=True)
        loss = loss + jcfg.proposal_loss_w * jax_proposal_bound_loss(
            comp_p["weights"], z_vals, out["weights_fine"], out["z_all"])
        return loss, (jax_img2mse(out["rgb"], target), out)

    (loss, (mse, out)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, c["params"]))
    return float(loss), float(mse), out, _flat(jax.tree.map(np.asarray, grads))


def _port_loss(c, epoch):
    """The port's stage1_loss (plain render) at `epoch`: (loss, mse,
    outputs, grads)."""
    params = params_from_numpy(c["params"])
    for _, leaf in named_leaves(params):
        leaf.requires_grad_(True)
    gen = torch.Generator().manual_seed(0)
    ro, rd, hist, target = map(torch.tensor, (c["ro"], c["rd"], c["hist"], c["target"]))
    with torch.no_grad():
        out = render_rays(params, c["model"], ro, rd, hist, c["st"], gen, epoch=epoch)
    loss, mse = stage1_loss(params, c["model"], c["cfg"], c["st"], ro, rd, target, hist,
                            gen, False, epoch)
    loss.backward()
    return (float(loss.detach()), float(mse.detach()), out,
            {p: t.grad.numpy() for p, t in named_leaves(params)})


def test_windowed_render_and_loss_match_jax(case):
    jl, jmse, want, jg = _jax_loss(case)
    tl, tmse, got, tg = _port_loss(case, case["epoch"])
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), atol=3e-2)
    np.testing.assert_allclose(got["rgb0"].numpy(), np.asarray(want["rgb0"]), atol=3e-2)
    assert np.isclose(tl, jl, rtol=1e-3), (tl, jl)
    assert np.isclose(tmse, jmse, rtol=1e-3), (tmse, jmse)
    assert _grads_close(tg, jg) == len(tg) >= 40
    if case["name"].startswith("zero"):
        # a closed window leaves only the identity columns of the PE: the
        # first layer's grads on every sine and cosine column are zero
        for path in ("coarse/xyz_0/w", "fine/xyz_0/w"):
            assert np.abs(tg[path][3:]).max() == 0.0, path


def test_the_port_without_the_epoch_fails_the_partial_window():
    """The control: the port's old behaviour (no epoch reaches the
    embedders, so the full PE) must not pass for the JAX run at a partial
    window."""
    case = _make_case("partial")
    _, _, _, jg = _jax_loss(case)
    _, _, _, tg = _port_loss(case, None)
    with pytest.raises(AssertionError):
        _grads_close(tg, jg)


@pytest.mark.parametrize("reduce_embedding", [2, -1])
def test_trainer_hands_its_epoch_to_the_embedders(monkeypatch, tmp_path,
                                                   reduce_embedding):
    """train_epoch(e) windows every xyz and direction embedding of its
    steps at e; render_split windows at global_step (JAX's eval epoch).
    Without --reduce_embedding 2 no epoch is passed (JAX's rule), and the
    kernel paths stay gated off for a windowed embedder."""
    flags = BASE[:-1] + [str(reduce_embedding), "--epochToMaxFreq", "8",
                         "--N_rand", "32", "--basedir", str(tmp_path), "--device", "cpu"]
    tr = NeRFTrainer(parse_args(flags, stage="nerf"),
                     make_synthetic_scene(n_train=2, n_val=1, H=8, W=8, focal=8.0, seed=0))
    if reduce_embedding == 2:
        assert not tr.uses_fused_train and not tr.uses_fast_render
    seen = []
    orig = Embedder.__call__

    def spy(self, x, epoch=None):
        if self is tr.model.embed_xyz or self is tr.model.embed_dir:
            seen.append(epoch)
        return orig(self, x, epoch)

    monkeypatch.setattr(Embedder, "__call__", spy)
    want = (lambda e: e) if reduce_embedding == 2 else (lambda e: None)
    tr.train_epoch(5)
    assert seen and all(e == want(5) for e in seen), seen
    seen.clear()
    tr.global_step = 7
    tr.render_split(tr.scene.val)
    assert seen and all(e == want(7) for e in seen), seen
