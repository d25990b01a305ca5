"""The stage-1 training slice, port against dfnet_tpu on the CPU.

Same seeded numpy inputs and params in both packages. The JAX kernels run
as its own tests run them: in interpret mode, with
fused_train.ALLOW_INTERPRET_TRAIN set inside a try/finally; the port's
wrappers run their plain PyTorch versions. Small nets (D <= 4, W <= 64,
one D=2 W=256 case), at most two JAX forward ray tiles. Tolerances are the
JAX package's own (tests/test_fused_train.py): gradients within
3e-2 * scale + 1e-7 per leaf (scale: the leaf's largest magnitude), forward
outputs within 5e-3, fine z samples within 2e-3, the loss within rtol 1e-3.
bf16 operands round at other places in the two packages, hence the
scale-relative gradient bar."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dfnet_tpu.render.fused_train as jft
from dfnet_tpu.config import parse_args as jax_parse_args
from dfnet_tpu.data.synthetic import make_synthetic_scene as jax_scene
from dfnet_tpu.models import nerfw as jnerfw
from dfnet_tpu.models.embedder import get_embedder as jax_embedder
from dfnet_tpu.models.factory import create_nerfh as jax_create_nerfh
from dfnet_tpu.models.factory import render_settings as jax_render_settings
from dfnet_tpu.models.losses import img2mse as jax_img2mse
from dfnet_tpu.models.losses import nerfw_loss as jax_nerfw_loss
from dfnet_tpu.models.losses import proposal_bound_loss as jax_proposal_bound_loss
from dfnet_tpu.ops import nerf_kernels as jnk
from dfnet_tpu.render.volume import composite_nerfw as jax_composite_nerfw
from dfnet_tpu.render.volume import render_rays as jax_render_rays
from dfnet_tpu.training.nerf_trainer import NeRFTrainer as JaxTrainer
from dfnet_tpu_torch.cli import nerf as cli
from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.models import nerfw as tnerfw
from dfnet_tpu_torch.models.embedder import get_embedder
from dfnet_tpu_torch.models.factory import render_settings
from dfnet_tpu_torch.ops import nerf_kernels as nk
from dfnet_tpu_torch.render.fast import kernels_serve
from dfnet_tpu_torch.render.fused_train import RawSweep, raw_sweep, render_rays_train_fused
from dfnet_tpu_torch.render.volume import render_rays
from dfnet_tpu_torch.training.checkpoints import params_from_numpy
from dfnet_tpu_torch.training.nerf_trainer import (
    NeRFTrainer,
    exp_decayed_lr,
    named_leaves,
    stage1_loss,
)

NEAR, FAR = 0.5, 3.5
SMALL = ["--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
         "--netdepth", "4", "--netwidth", "32", "--netdepth_fine", "4",
         "--netwidth_fine", "32", "--N_samples", "16", "--N_importance", "16",
         "--precision", "bf16", "--perturb", "0"]


def _assert_grads_close(got, want, skip_prefix=None):
    """Every leaf of two {path: array} grads within 3e-2 * scale + 1e-7."""
    assert sorted(got) == sorted(want)
    checked = 0
    for path, w in want.items():
        if skip_prefix and path.startswith(skip_prefix):
            continue
        g, w = np.asarray(got[path], np.float64), np.asarray(w, np.float64)
        scale = max(np.abs(g).max(), np.abs(w).max(), 1e-6)
        err = np.abs(g - w).max()
        assert err < 3e-2 * scale + 1e-7, f"{path}: err {err:.2e} scale {scale:.2e}"
        checked += 1
    return checked


def _flat(tree):
    return {p: np.asarray(v) for p, v in named_leaves(tree)}


def _rays(N, seed):
    rng = np.random.default_rng(seed)
    ro = (rng.normal(size=(N, 3)) * 0.3).astype(np.float32)
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


# ---------------------------------------------------------------------------
# the raw sweep: pack -> fine_raw_t under the custom VJP / RawSweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,D,W,skip", [
    ("fine", 4, 64, 2), ("static", 4, 64, 2), ("fine", 2, 256, 1)])
def test_raw_sweep_grads_match_jax(mode, D, W, skip):
    F, S = 10, 64
    fine = mode == "fine"
    kw = dict(D=D, W=W, skips=(skip,), in_xyz=6 * F + 3, in_dir=27,
              encode_appearance=fine, encode_transient=True)
    jc = jnerfw.NeRFWConfig(**kw)
    tc = tnerfw.NeRFWConfig(**kw)
    jp = jax.tree.map(np.asarray, jnerfw.init_nerfw_params(jax.random.PRNGKey(D + W), jc))
    N = 2 * jnk.tile_geometry(S, target=1024 if W <= 128 else 512)[0]
    ro, rd = _rays(N, seed=W)
    rng = np.random.default_rng(W + 1)
    z = np.sort(rng.uniform(NEAR, FAR, (N, S)), -1).astype(np.float32)
    d = rng.normal(size=(N, 27)).astype(np.float32)
    a = rng.normal(size=(N, 50)).astype(np.float32)
    t = rng.normal(size=(N, 20)).astype(np.float32)
    rows = nk.N_RAW if fine else nk.N_STATIC
    # A one-signed cotangent, as a loss gives. With a zero-mean one the trunk
    # grads are sums of cancelling terms, and either package's bf16 rounding
    # moves them by ~10% (both equally far from a float32 reference).
    g = rng.uniform(size=(rows, N, S)).astype(np.float32)
    spec_j = jnk.KernelSpec(D=D, skip=skip, F=F, fine=fine)

    def jax_raw(p):
        if fine:
            packed = jnk.pack_fine_t(p, jc, jax_embedder(F))
            dpt = jnk.per_ray_row(p, jc, d, a, t)
        else:
            packed = jnk.pack_static_t(p, jc, jax_embedder(F))
            dpt = jnk.per_ray_row_static(p, jc, d)
        return jft.raw_sweep_ad(packed, jnp.asarray(ro), jnp.asarray(rd),
                                jnp.asarray(z), dpt, spec_j, True)

    out, vjp = jax.vjp(jax_raw, jax.tree.map(jnp.asarray, jp))
    g16 = np.zeros((jnk.OUT_ROWS, N, S), np.float32)
    g16[:rows] = g
    (want,) = vjp(jnp.asarray(g16))

    tp = params_from_numpy(jp)
    for _, leaf in named_leaves(tp):
        leaf.requires_grad_(True)
    emb = get_embedder(F)
    if fine:
        packed = nk.pack_fine_t(tp, tc, emb)
        dpt = nk.per_ray_row(tp, tc, *map(torch.tensor, (d, a, t)))
    else:
        packed = nk.pack_static_t(tp, tc, emb)
        dpt = nk.per_ray_row_static(tp, tc, torch.tensor(d))
    spec = nk.spec_of(tc, emb, fine=fine, static=not fine)
    raw = raw_sweep(packed, torch.tensor(ro), torch.tensor(rd), torch.tensor(z), dpt, spec)
    assert raw.shape == (rows, N, S)
    np.testing.assert_allclose(raw.detach().numpy(), np.asarray(out)[:rows],
                               atol=2e-2, rtol=2e-2)
    raw.backward(torch.tensor(g))
    got = {p: np.zeros(t.shape) if t.grad is None else t.grad.numpy()
           for p, t in named_leaves(tp)}      # the static pack leaves trans_* out
    assert _assert_grads_close(got, _flat(jax.tree.map(np.asarray, want))) == len(got)


@pytest.mark.parametrize("static", [False, True])
def test_raw_bwd_plain_matches_autograd(static):
    """raw_bwd_plain (the kernel's arithmetic) against torch autograd
    through fine_raw_plain on the same packed tensors."""
    cfg = tnerfw.NeRFWConfig(D=4, W=64, skips=(2,), encode_appearance=True,
                             encode_transient=True)
    params = tnerfw.init_nerfw_params(torch.Generator().manual_seed(1), cfg)
    emb = get_embedder(10)
    packed = (nk.pack_static_t if static else nk.pack_fine_t)(params, cfg, emb)
    packed = {k: v.detach() for k, v in packed.items()}
    spec = nk.spec_of(cfg, emb, fine=not static, static=static)
    N, S = 7, 24                      # ragged against any tile
    ro, rd = map(torch.tensor, _rays(N, seed=3))
    rng = np.random.default_rng(4)
    z = torch.tensor(np.sort(rng.uniform(NEAR, FAR, (N, S)), -1).astype(np.float32))
    dpt = torch.tensor(rng.normal(size=(N, spec.Wd)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(spec.n_raw, N, S)).astype(np.float32))
    d_w, d_b, d_dpt = nk.raw_bwd_t(packed, ro, rd, z, dpt, g, spec)
    assert d_w.dtype == torch.bfloat16 and d_b.dtype == torch.float32
    w = packed["w"].clone().requires_grad_(True)
    b = packed["b"].clone().requires_grad_(True)
    dp = dpt.clone().requires_grad_(True)
    nk.fine_raw_plain({"w": w, "b": b, "freqs": packed["freqs"]}, ro, rd, z, dp,
                      spec).backward(g)
    got = {**nk.unpack({"w": d_w, "b": d_b}, spec), "dpt": d_dpt}
    want = {**nk.unpack({"w": w.grad, "b": b.grad}, spec), "dpt": dp.grad}
    _assert_grads_close({k: v.float().numpy() for k, v in got.items()},
                        {k: v.float().numpy() for k, v in want.items()})


def test_raw_sweep_forward_saves_inputs_only():
    """RawSweep's forward is fine_raw_t and keeps no activations."""
    cfg = tnerfw.NeRFWConfig(D=2, W=32, skips=(), encode_appearance=True,
                             encode_transient=True)
    params = tnerfw.init_nerfw_params(torch.Generator().manual_seed(2), cfg)
    emb = get_embedder(10)
    packed = nk.pack_fine_t(params, cfg, emb)
    spec = nk.spec_of(cfg, emb, fine=True)
    ro, rd = map(torch.tensor, _rays(3, seed=5))
    z = torch.linspace(NEAR, FAR, 8).expand(3, 8).contiguous()
    dpt = torch.zeros((3, 32), requires_grad=True)
    out = RawSweep.apply(packed["w"], packed["b"], packed["freqs"], ro, rd, z, dpt, spec)
    torch.testing.assert_close(out, nk.fine_raw_plain(packed, ro, rd, z, dpt, spec))
    assert len(out.grad_fn.saved_tensors) == 7


# ---------------------------------------------------------------------------
# the fused train render, the plain train render and the stage-1 loss
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """D=4 W=32 nets (16+16 samples, the proposal on) after 96 steps of the
    port's trainer on the synthetic scene, and one ray batch. At the
    initialisation the coarse sigma grads vanish (sigma and colour hardly
    change along a ray) to ~1e-6, where bf16 rounding noise dominates."""
    jcfg = jax_parse_args(SMALL, stage="nerf")
    jmodel, init = jax_create_nerfh(jcfg, jax.random.PRNGKey(0))
    jst = jax_render_settings(jcfg, NEAR, FAR)
    cfg = parse_args(SMALL + ["--device", "cpu"], stage="nerf")
    tr = NeRFTrainer(cfg.replace(perturb=1.0, N_rand=256, lrate=5e-3),
                     make_synthetic_scene(seed=0))
    init = jax.tree.map(np.asarray, init)
    tr.load_params_tree(init)
    for epoch in range(8):
        tr.train_epoch(epoch)
    st = render_settings(cfg, NEAR, FAR)
    n = jft.train_ray_align(jst, jmodel.cfg_coarse.W, jmodel.cfg_fine.W)
    ro, rd = _rays(n, seed=7)
    rng = np.random.default_rng(8)
    hist = np.broadcast_to(rng.integers(0, 20, (1, jcfg.hist_bin)),
                           (n, jcfg.hist_bin)).astype(np.int32)
    target = rng.uniform(size=(n, 3)).astype(np.float32)
    np_params = {k: ({q: {r: w.detach().numpy() for r, w in v2.items()}
                      for q, v2 in v.items()} if isinstance(v, dict)
                     else v.detach().numpy()) for k, v in tr.params.items()}
    return dict(jcfg=jcfg, jmodel=jmodel, jst=jst, cfg=cfg, model=tr.model, st=st,
                init_params=init, np_params=np_params, ro=ro, rd=rd, hist=hist,
                target=target)


def _jax_loss(s, fused):
    """The JAX trainer's loss_fn (nerf_trainer.py:137-177) at perturb=0."""
    jm, jcfg = s["jmodel"], s["jcfg"]
    ro, rd, hist, target = map(jnp.asarray, (s["ro"], s["rd"], s["hist"], s["target"]))
    render = jft.render_rays_train_fused if fused else jax_render_rays

    def loss_fn(p):
        out = render(p, jm, ro, rd, hist, s["jst"], jax.random.PRNGKey(0))
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
        jax.tree.map(jnp.asarray, s["np_params"]))
    return float(loss), float(mse), out, _flat(jax.tree.map(np.asarray, grads))


def _port_loss(s, fused):
    params = params_from_numpy(s["np_params"])
    for _, leaf in named_leaves(params):
        leaf.requires_grad_(True)
    gen = torch.Generator().manual_seed(0)
    render = render_rays_train_fused if fused else render_rays
    args = [torch.tensor(s[k]) for k in ("ro", "rd")]
    hist, target = torch.tensor(s["hist"]), torch.tensor(s["target"])
    with torch.no_grad():
        out = render(params, s["model"], *args, hist, s["st"], gen)
    loss, mse = stage1_loss(params, s["model"], s["cfg"], s["st"], *args, target,
                            hist, gen, fused)
    loss.backward()
    return (float(loss.detach()), float(mse.detach()), out,
            {p: t.grad.numpy() for p, t in named_leaves(params)})


@pytest.fixture(scope="module")
def runs(small):
    """(loss, mse, outputs, grads) of both packages' fused and plain steps."""
    old = jft.ALLOW_INTERPRET_TRAIN
    jft.ALLOW_INTERPRET_TRAIN = True
    try:
        return {("jax", fused): _jax_loss(small, fused) for fused in (True, False)} | {
            ("port", fused): _port_loss(small, fused) for fused in (True, False)}
    finally:
        jft.ALLOW_INTERPRET_TRAIN = old


def test_kernels_serve_the_train_step(small):
    assert kernels_serve(small["model"], small["st"], train=True)
    import dataclasses

    odd = dataclasses.replace(small["model"], cfg_fine=dataclasses.replace(
        small["model"].cfg_fine, W=192))
    assert not kernels_serve(odd, small["st"], train=True)


def test_render_rays_train_fused_matches_jax(small):
    """Forward outputs at the initialisation (at the trained state the
    peaked coarse weights move a few of the fine z's by more than 2e-3)."""
    jft.ALLOW_INTERPRET_TRAIN, old = True, jft.ALLOW_INTERPRET_TRAIN
    try:
        want = jft.render_rays_train_fused(
            jax.tree.map(jnp.asarray, small["init_params"]), small["jmodel"],
            *map(jnp.asarray, (small["ro"], small["rd"], small["hist"])),
            small["jst"], jax.random.PRNGKey(0))
    finally:
        jft.ALLOW_INTERPRET_TRAIN = old
    with torch.no_grad():
        got = render_rays_train_fused(
            params_from_numpy(small["init_params"]), small["model"],
            *map(torch.tensor, (small["ro"], small["rd"], small["hist"])),
            small["st"], torch.Generator().manual_seed(0))
    for k in ("rgb0", "rgb", "beta", "acc", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=5e-3,
                                   err_msg=k)
    for k in ("z_all", "z_std"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-3,
                                   err_msg=k)


def test_fused_stage1_loss_and_grads_match_jax(runs):
    """The loss against JAX's fused step; every leaf's grad (the proposal's
    too) against JAX's reference step (plain render_rays), the path both
    fused steps are held to. JAX's own fused backward departs from that
    reference by more than the bar on the coarse first layer at this state,
    while the port's stays within it (ROADMAP.md, Queue 3)."""
    jl, jmse, _, _ = runs["jax", True]
    tl, tmse, _, tg = runs["port", True]
    assert np.isclose(tl, jl, rtol=1e-3), (tl, jl)
    assert np.isclose(tmse, jmse, rtol=1e-3), (tmse, jmse)
    assert _assert_grads_close(tg, runs["jax", False][3]) == len(tg) >= 40


def test_fused_grads_nonzero_on_every_leaf(runs):
    for path, v in runs["port", True][3].items():
        if not path.startswith("proposal/"):
            assert np.abs(v).max() > 0, f"zero grad at {path}"


def test_plain_train_render_rays_matches_jax(runs):
    jl, _, want, jg = runs["jax", False]
    tl, _, got, tg = runs["port", False]
    for k in ("rgb0", "rgb", "beta", "acc", "depth", "z_all"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=5e-3,
                                   err_msg=k)
    assert np.isclose(tl, jl, rtol=1e-3), (tl, jl)
    assert _assert_grads_close(tg, jg) == len(tg)


def test_train_draws_need_a_generator_on_the_device():
    from dfnet_tpu_torch.render.sampling import gaussian, stratified_z_vals, uniform

    cpu_gen = torch.Generator().manual_seed(0)
    for draw in (uniform, gaussian):
        with pytest.raises(ValueError, match="torch.Generator"):
            draw((2,), cpu_gen, "meta")
    near = torch.zeros((2, 1))
    z = stratified_z_vals(near, near + 1, 4, cpu_gen, perturb=1.0)
    assert z.shape == (2, 4) and not torch.equal(z, stratified_z_vals(near, near + 1, 4))


# ---------------------------------------------------------------------------
# Adam, checkpoints, the CLI
# ---------------------------------------------------------------------------

TINY = ["--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
        "--netdepth", "2", "--netwidth", "32", "--netdepth_fine", "2",
        "--netwidth_fine", "32", "--N_samples", "8", "--N_importance", "8",
        "--N_rand", "64", "--expname", "nerfh"]


def _tiny_trainer(tmp_path, device="cpu"):
    cfg = parse_args(TINY + ["--basedir", str(tmp_path), "--device", device])
    return NeRFTrainer(cfg, make_synthetic_scene(n_train=2, n_val=1, H=8, W=8,
                                                 focal=8.0, seed=0))


def _jax_tiny_trainer(tmp_path):
    cfg = jax_parse_args(TINY + ["--basedir", str(tmp_path)], stage="nerf")
    return JaxTrainer(cfg, jax_scene(n_train=2, n_val=1, H=8, W=8, focal=8.0, seed=0))


def _random_grads(trainer, seed):
    rng = np.random.default_rng(seed)
    return {p: rng.normal(size=t.shape).astype(np.float32) for p, t in trainer._named}


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def test_adam_matches_optax(tmp_path):
    tr = _tiny_trainer(tmp_path)
    params = jax.tree.map(jnp.asarray, _unflat(
        {p: t.detach().numpy() for p, t in tr._named}))
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=tr.cfg.lrate, b1=0.9,
                                               b2=0.999)
    state = opt.init(params)
    for k in range(3):
        lr = exp_decayed_lr(tr.cfg, 40000 * k)
        grads = _random_grads(tr, seed=k)
        state.hyperparams["learning_rate"] = lr
        updates, state = opt.update(jax.tree.map(jnp.asarray, _unflat(grads)), state,
                                    params)
        params = optax.apply_updates(params, updates)
        for p, t in tr._named:
            t.grad = torch.tensor(grads[p])
        tr.adam_update(lr)
    want = _flat(jax.tree.map(np.asarray, params))
    for p, t in tr._named:
        np.testing.assert_allclose(t.detach().numpy(), want[p], atol=1e-6, err_msg=p)
    count, _, mu, nu = state.count, None, state.inner_state[0].mu, state.inner_state[0].nu
    saved = tr.opt_state_tree()
    assert int(saved[0]) == int(count) == 3
    for mine, theirs in ((saved[3][0][1], mu), (saved[3][0][2], nu)):
        theirs = _flat(jax.tree.map(np.asarray, theirs))
        for p, v in _flat(mine).items():
            np.testing.assert_allclose(np.asarray(v), theirs[p], atol=1e-6, rtol=1e-5)


def test_port_checkpoint_resumes_warm_in_jax(tmp_path, capsys):
    tr = _tiny_trainer(tmp_path)
    for k in range(2):
        for p, t in tr._named:
            t.grad = torch.tensor(_random_grads(tr, seed=10 + k)[p])
        tr.adam_update(1e-3)
    tr.global_step = 3
    tr.save(3)
    jtr = _jax_tiny_trainer(tmp_path)
    assert jtr.try_resume() == 3
    out = capsys.readouterr().out
    assert "resumed from" in out and "cold" not in out
    assert int(jtr.opt_state.count) == 2
    adam = jtr.opt_state.inner_state[0]
    mine = tr.opt_state_tree()
    for jtree, ttree in ((jtr.params, tr.params), (adam.mu, mine[3][0][1]),
                         (adam.nu, mine[3][0][2])):
        want = _flat(jax.tree.map(np.asarray, jtree))
        got = {p: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
               for p, v in named_leaves(ttree)}
        assert sorted(got) == sorted(want)
        for p in want:
            np.testing.assert_array_equal(got[p], want[p], err_msg=p)


def test_jax_checkpoint_resumes_warm_in_port(tmp_path, capsys):
    jtr = _jax_tiny_trainer(tmp_path)
    rng = np.random.default_rng(20)
    jtr.opt_state = jax.tree.map(
        lambda x: (jnp.asarray(np.abs(rng.normal(size=x.shape)), x.dtype)
                   if x.ndim else (jnp.int32(5) if x.dtype == jnp.int32 else x)),
        jtr.opt_state)
    jtr.global_step = 4
    jtr.save(4)
    tr = _tiny_trainer(tmp_path)
    assert tr.try_resume() == 4
    out = capsys.readouterr().out
    assert "resumed from" in out and "cold" not in out
    adam = jtr.opt_state.inner_state[0]
    want_mu = _flat(jax.tree.map(np.asarray, adam.mu))
    want_nu = _flat(jax.tree.map(np.asarray, adam.nu))
    want_p = _flat(jax.tree.map(np.asarray, jtr.params))
    for p, t in tr._named:
        st = tr.optimizer.state[t]
        assert float(st["step"]) == 5
        np.testing.assert_array_equal(t.detach().numpy(), want_p[p])
        np.testing.assert_array_equal(st["exp_avg"].numpy(), want_mu[p])
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), want_nu[p])
    # the restored moments drive the next update like any other
    for _, t in tr._named:
        t.grad = torch.ones_like(t)
    tr.adam_update(1e-3)
    assert float(tr.optimizer.state[tr._named[0][1]]["step"]) == 6


def test_cli_trains_then_render_test_resumes(tmp_path, capsys):
    argv = ["--config", "configs/config_synthetic.txt", "--basedir", str(tmp_path),
            "--device", "cpu", "--netdepth", "2", "--netwidth", "32",
            "--netdepth_fine", "2", "--netwidth_fine", "32", "--N_samples", "16",
            "--N_importance", "16", "--N_rand", "128", "--lrate", "2e-3"]
    psnr = cli.train(argv + ["--epochs", "5", "--i_weights", "2", "--i_testset", "4"])
    out = capsys.readouterr().out
    exp = tmp_path / "nerfh"
    assert "train step: kernels (fused_train)" in out
    assert [f for f in sorted(os.listdir(exp)) if f.endswith(".npz")] == [
        "000002.npz", "000004.npz"]
    assert out.count("[TRAIN] Iter:") == 6 and "[EVAL] epoch 4" in out
    assert np.isfinite(psnr)
    with open(exp / "metrics.jsonl") as fh:
        loss = [json.loads(line)["loss"] for line in fh]
    assert len(loss) == 6 and np.all(np.isfinite(loss))
    assert np.mean(loss[-2:]) < np.mean(loss[:2]), loss
    cli.train(argv + ["--render_test"])
    out = capsys.readouterr().out
    assert f"resumed from {exp / '000004.npz'} at step 5" in out
    assert "Mean PSNR of this run is:" in out
