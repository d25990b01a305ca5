"""The vanilla NeRF (NeRFH=False), port against dfnet_tpu on the CPU.

Same seeded numpy inputs and the JAX package's params (carried across
unchanged: both packages keep Linear w as (in, out)) through the MLP, the
compositing, the coarse -> fine render and one stage-1 step, at D=4 W=32
with skips (2,). Bars: the MLP at float32 1e-5 and bf16 2e-2
(tests/test_fast_render.py:70); compositing 1e-6; the render at
perturb=0, raw_noise_std=0 at 1e-5 up to the sampler and on shared
samples, sample_pdf's fine z at 2e-3 (tests/test_fast_render.py:239); the step (plain float32 on both sides, no
kernel) at 1e-5 of the loss and 1e-4 of each coarse gradient leaf's scale.
Past the inverse-CDF sampler float32 rounding moves the fine samples, and
the fine outputs and gradients are held at bars measured against float64
runs (RENDER_BARS, STEP_FINE_GRAD).

The CLIs are held in tests/test_torch_port_vanilla_cli.py."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfnet_tpu.models import nerf_vanilla as jnv
from dfnet_tpu.models.embedder import get_embedder as jax_embedder
from dfnet_tpu.models.losses import nerfw_loss as jax_nerfw_loss
from dfnet_tpu.render import volume as jvol
from dfnet_tpu.render.rays import get_rays as jax_get_rays
from dfnet_tpu.render.sampling import sample_pdf as jax_sample_pdf
from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.models import nerf_vanilla as nv
from dfnet_tpu_torch.models.embedder import get_embedder
from dfnet_tpu_torch.render import fast
from dfnet_tpu_torch.render import volume as vol
from dfnet_tpu_torch.render.sampling import sample_pdf
from dfnet_tpu_torch.training import parity
from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer, named_leaves

NEAR, FAR = 0.5, 3.5
KW = dict(D=4, W=32, skips=(2,), in_xyz=63, in_dir=27)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes gain nothing from intra-op threads, and test workers that
    each run a thread a core slow one another down: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t_tree(tree):
    return {k: _t_tree(v) if isinstance(v, dict) else torch.tensor(np.asarray(v))
            for k, v in tree.items()}


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    ro = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 1.0
    return ro, rd


# ---------------------------------------------------------------- the MLP

@pytest.mark.parametrize("viewdirs", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_nerf_apply_rays_matches_jax(viewdirs, dtype):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    jc = jnv.VanillaNeRFConfig(**KW, use_viewdirs=viewdirs, output_ch=5, compute_dtype=jdt)
    tc = nv.VanillaNeRFConfig(**KW, use_viewdirs=viewdirs, output_ch=5, compute_dtype=tdt)
    params = _np_tree(jnv.init_nerf_params(jax.random.PRNGKey(1), jc))
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(7, 5, 63)).astype(np.float32)
    d = rng.normal(size=(7, 27)).astype(np.float32)
    want = jnv.nerf_apply_rays(params, jc, jnp.asarray(xyz), jnp.asarray(d) if viewdirs
                               else None)
    got = nv.nerf_apply_rays(_t_tree(params), tc, torch.tensor(xyz),
                             torch.tensor(d) if viewdirs else None)
    assert tuple(got.shape) == (7, 5, 4 if viewdirs else 5)
    _close(got, want, 1e-5 if dtype == "float32" else 2e-2)


def test_init_matches_jax_fan_ins():
    for viewdirs in (True, False):
        jp = jnv.init_nerf_params(jax.random.PRNGKey(0),
                                  jnv.VanillaNeRFConfig(**KW, use_viewdirs=viewdirs))
        tp = nv.init_nerf_params(torch.Generator().manual_seed(0),
                                 nv.VanillaNeRFConfig(**KW, use_viewdirs=viewdirs))
        assert sorted(tp) == sorted(jp)
        for k in jp:
            for leaf in ("w", "b"):
                assert tuple(tp[k][leaf].shape) == tuple(jp[k][leaf].shape), (k, leaf)
            bound = 1.0 / np.sqrt(jp[k]["w"].shape[0])
            assert float(tp[k]["w"].abs().max()) <= bound


def test_vanilla_state_dict_converter_bit_for_bit():
    g = torch.Generator().manual_seed(3)
    sd = {}
    for i, fin in enumerate((63, 32, 32, 95)):
        sd[f"pts_linears.{i}.weight"] = torch.randn((32, fin), generator=g)
        sd[f"pts_linears.{i}.bias"] = torch.randn(32, generator=g)
    for name, (o, i) in {"feature_linear": (32, 32), "alpha_linear": (1, 32),
                         "views_linears.0": (16, 59), "rgb_linear": (3, 16)}.items():
        sd[f"{name}.weight"] = torch.randn((o, i), generator=g)
        sd[f"{name}.bias"] = torch.randn(o, generator=g)
    got, want = nv.vanilla_state_dict_to_params(sd, D=4), jnv.vanilla_state_dict_to_params(sd, D=4)
    assert sorted(got) == sorted(want)
    for k in want:
        for leaf in ("w", "b"):
            a, b = got[k][leaf], np.asarray(want[k][leaf])
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------- compositing

@pytest.mark.parametrize("white_bkgd", [False, True])
def test_composite_vanilla_matches_jax(white_bkgd):
    rng = np.random.default_rng(1)
    raw = rng.normal(size=(9, 12, 5)).astype(np.float32)
    z = np.sort(rng.uniform(NEAR, FAR, (9, 12)), -1).astype(np.float32)
    rd = rng.normal(size=(9, 3)).astype(np.float32)
    noise = rng.normal(size=(9, 12)).astype(np.float32)
    want = jvol.composite_vanilla(*map(jnp.asarray, (raw, z, rd)),
                                  raw_noise=jnp.asarray(noise), white_bkgd=white_bkgd)
    got = vol.composite_vanilla(*map(torch.tensor, (raw, z, rd)),
                                raw_noise=torch.tensor(noise), white_bkgd=white_bkgd)
    for k in ("rgb", "disp", "acc", "weights", "depth"):
        _close(got[k], want[k], 1e-6)


# ---------------------------------------------------------------- the render

def _models(viewdirs=True):
    jc = jnv.VanillaNeRFConfig(**KW, use_viewdirs=viewdirs, output_ch=5)
    tc = nv.VanillaNeRFConfig(**KW, use_viewdirs=viewdirs, output_ch=5)
    jm = jvol.VanillaNeRFModel(jc, jc, jax_embedder(10, 0), jax_embedder(4, 0))
    tm = vol.VanillaNeRFModel(tc, tc, get_embedder(10, 0), get_embedder(4, 0))
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    params = {"coarse": _np_tree(jnv.init_nerf_params(k1, jm.cfg_coarse)),
              "fine": _np_tree(jnv.init_nerf_params(k2, jm.cfg_fine))}
    return jm, tm, params


# Past the inverse CDF, float32 rounding of the coarse weights moves the fine
# samples by ~1e-4, and the 1e10 terminal delta and the steep CDF carry that
# into the fine outputs: on these rays the JAX package's own float32 render is
# 4.0e-3 (rgb, acc), 7.1e-3 (disp) and 1.0e-2 (depth) relative from a float64
# run of the same pipeline, and the port's is as far. So the render's fine
# outputs are held at the repo's rendered-rgb bar, 3e-2
# (tests/test_fast_render.py:119), z_std at the fine-z bar, 2e-3. The coarse
# rgb at 1e-5, but acc and disp at 1e-4: 1 - exp(-x) keeps few digits for
# the small x a random net gives, and JAX's own acc0 is 1.3e-5 and disp0
# (acc / depth) 4.6e-5 relative from float64. The fine pass on shared
# samples is held at 1e-5 (test_fine_pass_on_shared_samples_matches_jax).
RENDER_BARS = {"rgb0": 1e-5, "acc0": 1e-4, "disp0": 1e-4, "rgb": 3e-2, "acc": 3e-2,
               "disp": 3e-2, "depth": 3e-2, "z_std": 2e-3}


def test_render_rays_vanilla_matches_jax():
    jm, tm, params = _models()
    ro, rd = _rays(33, 2)
    st = dict(N_samples=16, N_importance=16, perturb=0.0, raw_noise_std=0.0,
              near=NEAR, far=FAR)
    want = jvol.render_rays_vanilla(params, jm, jnp.asarray(ro), jnp.asarray(rd),
                                    jvol.RenderSettings(**st))
    got = vol.render_rays_vanilla(_t_tree(params), tm, torch.tensor(ro), torch.tensor(rd),
                                  vol.RenderSettings(**st))
    assert sorted(got) == sorted(want) == sorted(RENDER_BARS)
    for k, bar in RENDER_BARS.items():
        _close(got[k], want[k], bar)
    # the fine z: sample_pdf over the coarse weights, deterministic
    z = np.linspace(NEAR, FAR, 16, dtype=np.float32)[None].repeat(33, 0)
    w = np.random.default_rng(3).uniform(size=(33, 16)).astype(np.float32)
    zm = 0.5 * (z[:, 1:] + z[:, :-1])
    _close(sample_pdf(torch.tensor(zm), torch.tensor(w[:, 1:-1]), 16, det=True),
           jax_sample_pdf(jnp.asarray(zm), jnp.asarray(w[:, 1:-1]), 16, None, det=True),
           2e-3)


def test_fine_pass_on_shared_samples_matches_jax():
    """The fine net and composite_vanilla over the same sorted samples: the
    render past the sampler, at 1e-5."""
    jm, tm, params = _models()
    ro, rd = _rays(33, 2)
    z = np.sort(np.random.default_rng(4).uniform(NEAR, FAR, (33, 32)), -1).astype(np.float32)

    def fine(mod, model, p, ro, rd, z, norm):
        vd = rd / norm(rd)
        raw = mod.nerf_apply_rays(p["fine"], model.cfg_fine,
                                  model.embed_xyz(ro[:, None] + rd[:, None] * z[..., None]),
                                  model.embed_dir(vd))
        return raw

    jraw = fine(jnv, jm, params, *map(jnp.asarray, (ro, rd, z)),
                lambda d: jnp.linalg.norm(d, axis=-1, keepdims=True))
    traw = fine(nv, tm, _t_tree(params), *map(torch.tensor, (ro, rd, z)),
                lambda d: torch.linalg.norm(d, dim=-1, keepdim=True))
    want = jvol.composite_vanilla(jraw, jnp.asarray(z), jnp.asarray(rd))
    got = vol.composite_vanilla(traw, torch.tensor(z), torch.tensor(rd))
    for k in ("rgb", "acc", "depth", "disp"):
        _close(got[k], want[k], 1e-5)


def test_vanilla_render_agreement_runs_its_stages():
    """training/parity.py's card-against-CPU check, here CPU against CPU:
    every stage agrees exactly, and the check refuses random settings."""
    _, tm, params = _models()
    ro, rd = map(torch.tensor, _rays(40, 6))
    st = vol.RenderSettings(N_samples=16, N_importance=16, near=NEAR, far=FAR).test()
    ok, info = parity.vanilla_render_agreement(_t_tree(params), tm, ro, rd, st, "cpu")
    assert ok and max(info.values()) == 0.0, info
    with pytest.raises(ValueError, match="perturb 0"):
        parity.vanilla_render_agreement(_t_tree(params), tm, ro, rd,
                                        vol.RenderSettings(near=NEAR, far=FAR), "cpu")


def test_kernel_gates_refuse_the_vanilla_model():
    """The kernel gate admits this pair (tests/test_torch_vanilla_kernel_route.py
    holds that route) and refuses it outside the kernels' envelope, where the
    plain route above serves it: a skip into the heads, two skips, no
    viewdirs, a width off 32, a windowed PE, the culled schedules."""
    _, tm, _ = _models()
    st = vol.RenderSettings(N_samples=16, N_importance=16)
    assert fast.kernels_serve(tm, st.test())
    assert fast.kernels_serve(tm, st, train=True)
    cfgs = [dict(skips=(3,)), dict(skips=(1, 2)), dict(use_viewdirs=False), dict(W=48)]
    for kw in cfgs:
        c = nv.VanillaNeRFConfig(**{**KW, **kw})
        m = vol.VanillaNeRFModel(c, c, tm.embed_xyz, tm.embed_dir)
        assert not fast.kernels_serve(m, st.test()), kw
        assert not fast.kernels_serve(m, st, train=True), kw
    windowed = vol.VanillaNeRFModel(tm.cfg_coarse, tm.cfg_fine, get_embedder(10, 0, 2, 100),
                                    tm.embed_dir)
    assert not fast.kernels_serve(windowed, st.test())
    assert not fast.kernels_serve(windowed, st, train=True)
    assert not fast.kernels_serve(tm, st.test(), cull_q=2e-3)
    culled = vol.RenderSettings(N_samples=16, N_importance=16, train_cull_q=2e-3,
                                train_fine_total=16)
    assert not fast.kernels_serve(tm, culled, train=True)


def test_render_image_dispatches_on_the_model():
    jm, tm, params = _models()
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 2.0
    st = dict(N_samples=8, N_importance=8, near=NEAR, far=FAR)
    want = jvol.render_image(params, jm, jnp.asarray(c2w), jnp.zeros(10, jnp.int32), 6, 8,
                             7.0, jvol.RenderSettings(**st).test(), chunk=16)
    got = vol.render_image(_t_tree(params), tm, torch.tensor(c2w), None, 6, 8, 7.0,
                           vol.RenderSettings(**st).test(), chunk=16)
    for k in ("rgb", "disp", "acc"):
        assert tuple(got[k].shape) == tuple(want[k].shape)
        _close(got[k], want[k], RENDER_BARS[k])


# ---------------------------------------------------------------- one step

# The coarse leaves' gradients are held at 1e-4 of their scale. The fine net
# sees samples placed by the inverse CDF, which float32 rounding of the
# coarse weights moves: on this step JAX's own fine-leaf gradients are up to
# 3.1e-3 of scale from a float64 run of the same loss (the port's 4.2e-3;
# each coarse leaf within 1.3e-5 on both sides), so the fine leaves are held
# at 1e-2 of scale, about three times JAX's own float32 error.
STEP_FINE_GRAD = 1e-2
# the plain route, pinned by the flags (the gates admit this pair)
STEP = ["--dataset_type", "synthetic", "--netdepth", "4", "--netwidth", "32",
        "--netdepth_fine", "4", "--netwidth_fine", "32", "--N_samples", "16",
        "--N_importance", "16", "--N_rand", "256", "--perturb", "0",
        "--fused_train", "false", "--fast_render", "false"]


def test_stage1_train_step_matches_jax():
    """The port's NeRFTrainer.train_step (its pixel selection read from a copy
    of its generator) against the JAX trainer's loss (render_rays_vanilla +
    nerfw_loss: c_l + f_l) and jax.value_and_grad on the same rays."""
    cfg = parse_args(STEP + ["--device", "cpu"], stage="nerf")
    assert not cfg.NeRFH and cfg.raw_noise_std == 0.0
    scene = make_synthetic_scene(n_train=2, n_val=1, H=24, W=32, focal=30.0, seed=0)
    tr = NeRFTrainer(cfg, scene)
    jm, tm, params = _models()
    tr.model = tm
    tr.load_params_tree(params)
    assert not tr.uses_fused_train
    sel = torch.randperm(24 * 32, generator=torch.Generator().set_state(
        tr.gen.get_state()))[:256].numpy()
    loss, _ = tr.train_step(1, 0.0)
    grads = {p: t.grad.numpy() for p, t in tr._named}

    ro, rd = jax_get_rays(24, 32, 30.0, jnp.asarray(scene.train.poses[1]))
    ro, rd = ro.reshape(-1, 3)[sel], rd.reshape(-1, 3)[sel]
    target = jnp.asarray(scene.train.images[1].reshape(-1, 3)[sel])
    jst = jvol.RenderSettings(N_samples=16, N_importance=16, perturb=0.0, near=scene.near,
                              far=scene.far)

    def loss_fn(p):
        out = jvol.render_rays_vanilla(p, jm, ro, rd, jst)
        losses = jax_nerfw_loss(out, target)
        assert sorted(losses) == ["c_l", "f_l"]
        return sum(losses.values())

    jloss, jgrads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, params))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = {p: np.asarray(v) for p, v in named_leaves(_np_tree(jgrads))}
    assert sorted(grads) == sorted(want)
    for p, w in want.items():
        scale = max(np.abs(w).max(), 1e-12)
        bar = STEP_FINE_GRAD if p.startswith("fine/") else 1e-4
        assert np.abs(grads[p] - w).max() <= bar * scale, p
        assert np.abs(w).max() > 0, p
