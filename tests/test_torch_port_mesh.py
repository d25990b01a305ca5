"""The data mesh (dfnet_tpu_torch/parallel/mesh.py) and stage 1 on it,
world 2 against world 1 in the port and against the JAX package's
make_mesh(2), on the CPU.

World 2 is two gloo processes spawned by mesh.launch (each on one torch
thread, as world 1 runs here); they import only the port and run dfnet_tpu_torch/parallel/
checks.py, which builds the same trainer from the same config, params and
inputs as the world-1 run in this process. One launch serves every stage-1
and render case. Bars: world 2 against world 1, the loss within rtol 1e-5
and every leaf's grad within 1e-5 of its scale (its largest magnitude);
renders within 1e-5. Against JAX's step under make_mesh(2) (GSPMD over the
conftest's virtual CPU devices, the plain reference render), the
fused-train bars of tests/test_fused_train.py: the loss within rtol 1e-3,
grads within 3e-2 * scale + 1e-7. The control, where every rank skips the
grads' all-reduce, must miss the world-1 bar."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

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
from dfnet_tpu.parallel.mesh import data_sharding
from dfnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dfnet_tpu.render.volume import composite_nerfw as jax_composite_nerfw
from dfnet_tpu.render.volume import render_rays as jax_render_rays
from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.parallel import checks
from dfnet_tpu_torch.parallel import mesh as pmesh
from dfnet_tpu_torch.parallel.mesh import Mesh, launch, make_mesh, mesh_from_config
from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer, named_leaves

SMALL = ["--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
         "--netdepth", "2", "--netwidth", "32", "--netdepth_fine", "2",
         "--netwidth_fine", "32", "--N_samples", "16", "--N_importance", "16",
         "--precision", "bf16", "--N_rand", "128", "--chunk", "128",
         "--device", "cpu"]
WORLD = {"pose_scale": 0.8, "pose_scale2": 1.25, "move_all_cam_vec": [0.1, -0.05, 0.2]}
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """World 1 on one thread, as each rank runs: the replicated parts then
    sum in the same order in both worlds (and test workers do not
    oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
    return make_synthetic_scene(n_train=3, n_val=2, H=16, W=20, focal=18.0, seed=0)


def _cfg(*flags, **kw):
    return parse_args(SMALL + list(flags), stage="nerf").replace(**kw)


def _close(got, want, tol=TOL, floor=0.0, shares=()):
    """Worst |got - want| over (tol * scale + floor) across a grads dict
    (< 1 passes). A leaf's scale is its largest magnitude, or that of the
    sum of the ranks' |shares| where they cancel to less: the float32
    all-reduce adds them, so its rounding is relative to them."""
    assert sorted(got) == sorted(want)
    worst = 0.0
    for k, w in want.items():
        g = np.asarray(got[k], np.float64)
        w = np.asarray(w, np.float64)
        terms = sum(np.abs(np.asarray(s[k], np.float64)) for s in shares)
        scale = max(np.abs(g).max(), np.abs(w).max(), np.max(terms), 1e-12)
        worst = max(worst, np.abs(g - w).max() / (tol * scale + floor))
    return worst


# ---------------------------------------------------------------------------
# mesh_from_config and the collectives
# ---------------------------------------------------------------------------

def test_mesh_from_config_semantics(monkeypatch):
    """None and 1 mean one device (no process group); on the CPU any n is
    n gloo ranks and 0 raises; on CUDA 0 is every GPU and more ranks than
    GPUs raise, as JAX's make_mesh, unless share_device puts them on cuda:0
    over gloo."""
    cfg = _cfg()
    assert mesh_from_config(cfg) is None
    assert mesh_from_config(cfg.replace(mesh_shape=1)) is None
    assert make_mesh(1, "cuda") is None               # one device needs no GPU check
    m = mesh_from_config(cfg.replace(mesh_shape=3))
    assert m == Mesh(3, "cpu") and m.backend == "gloo" and m.device(2).type == "cpu"
    with pytest.raises(ValueError, match="explicitly"):
        mesh_from_config(cfg.replace(mesh_shape=0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    gpu = cfg.replace(device="cuda")
    assert mesh_from_config(gpu.replace(mesh_shape=0)) == Mesh(2, "cuda")
    m = mesh_from_config(gpu.replace(mesh_shape=2))
    assert m.backend == "nccl" and [str(m.device(r)) for r in (0, 1)] == ["cuda:0", "cuda:1"]
    with pytest.raises(ValueError, match="requested 4 devices but only 2"):
        mesh_from_config(gpu.replace(mesh_shape=4))
    shared = make_mesh(4, "cuda", share_device=True)
    assert shared.backend == "gloo" and str(shared.device(3)) == "cuda:0"
    assert "gloo, world size 4, devices cuda:0" == shared.describe()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh_from_config(gpu.replace(mesh_shape=0)) is None


def test_helpers_are_the_identity_without_a_process_group():
    x = torch.arange(6.0).reshape(3, 2)
    assert pmesh.gather_rows(x, [3]) is x and pmesh.shard_rows(7) == (0, 7)
    assert pmesh.is_main() and pmesh.row_counts(7, 3) == [3, 2, 2]
    t = torch.ones(2, requires_grad=True)
    assert pmesh.all_reduce_grads_([t], 0.5) is None and t.grad is None
    assert pmesh.agree(1.5, 2) == (1.5, 2.0)


@pytest.mark.parametrize("n", [2, 3])
def test_gather_rows_and_grad_reduce_across_ranks(n):
    """gather_rows forward (uneven rows: rank r holds r + 1) and backward
    (each rank gets the summed cotangents of its rows), and
    all_reduce_grads_ with a leaf that has no grad on rank 0, against their
    closed forms on every rank."""
    res = launch(checks.collectives, Mesh(n, "cpu"), "cpu")
    assert len(res) == n
    for r in res:
        for k in ("gathered", "grad"):
            np.testing.assert_array_equal(r[k], r["want_" + k], err_msg=k)
        for k in ("a", "b", "extra"):       # weighted by 1/n in float32
            np.testing.assert_allclose(r[k], r["want_" + k], rtol=1e-6, err_msg=k)


def test_launch_raises_a_rank_failure():
    """A rank that raises stops the launch, and the error carries its
    traceback."""
    with pytest.raises(pmesh.RankFailed, match=r"(?s)rank \d of 2 failed.*KeyError"):
        launch(checks.run_all, Mesh(2, "cpu"), [("no_such_check", {})])


# ---------------------------------------------------------------------------
# stage 1 and the renders: world 2 against world 1 and against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained():
    """Params after 24 world-1 steps from the seeded init (at the init the
    coarse grads are ~1e-6, bf16 noise), as a numpy tree."""
    tr = NeRFTrainer(_cfg(lrate=5e-3), _scene())
    for epoch in range(8):
        tr.train_epoch(epoch)
    return {k: ({q: {r: w.detach().numpy() for r, w in v2.items()}
                 for q, v2 in v.items()} if isinstance(v, dict) else v.detach().numpy())
            for k, v in tr.params.items()}


def _jax_batch(n=128, seed=7):
    rng = np.random.default_rng(seed)
    ro = rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    rd = rng.normal(0, 1, (n, 3)).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 1.0
    target = rng.uniform(size=(n, 3)).astype(np.float32)
    hist = rng.integers(0, 20, (10,)).astype(np.int32)
    return ro, rd, target, hist


@pytest.fixture(scope="module")
def runs(trained):
    """Every stage-1 and render case, at world 1 here and at world 2 in one
    launch."""
    sc = _scene()
    pose, hist = sc.val.poses[0], sc.val.hists[0]
    tiny = _cfg("--tinyimg", "--tinyscale", "2").replace(chunk=64)
    cases = {
        "perturb_off": ("stage1_step", dict(cfg=_cfg(perturb=0.0), scene=sc,
                                            params=trained, idx=1)),
        "perturb_on": ("stage1_step", dict(cfg=_cfg(perturb=1.0, raw_noise_std=0.5),
                                           scene=sc, params=trained, idx=2)),
        "uneven": ("stage1_step", dict(cfg=_cfg(perturb=1.0, N_rand=77), scene=sc,
                                       params=trained, idx=0)),
        **{f"fp32_{k}": ("stage1_step", dict(
            cfg=_cfg("--precision", "fp32", perturb=p, N_rand=n, fused_train=False),
            scene=sc, params=trained, idx=1)) for k, p, n in
           (("perturb_off", 0.0, 128), ("perturb_on", 1.0, 128), ("uneven", 1.0, 77))},
        "jax_rays": ("stage1_step", dict(cfg=_cfg(perturb=0.0), scene=sc, params=trained,
                                         rays=_jax_batch())),
        "render": ("render_view", dict(cfg=_cfg(), scene=sc, params=trained, pose=pose,
                                       hist=hist)),
        "render_plain": ("render_view", dict(cfg=_cfg(fast_render=False,
                                                      reduce_embedding=2),
                                             scene=sc, params=trained, pose=pose,
                                             hist=hist)),
        "prerender": ("frozen_prerender", dict(cfg=tiny, hwf=sc.hwf, near=sc.near,
                                               far=sc.far, world_setup=WORLD,
                                               params=trained, poses=sc.train.poses,
                                               hists=sc.train.hists)),
    }
    control = ("stage1_step", dict(cases["perturb_on"][1], skip_reduce=True))
    mesh = Mesh(2, "cpu")
    world2 = launch(checks.run_all, mesh, [(f, dict(kw, mesh=mesh)) for f, kw in
                                           list(cases.values()) + [control]])
    world1 = checks.run_all(list(cases.values()))
    return ({k: v for k, v in zip(cases, world1)},
            {k: v for k, v in zip(list(cases) + ["control"], world2)})


def _bf16_bar(got, want, shares):
    """Worst |got - want| over the bound of bf16 rounding, u * (sum_r
    |share_r| + |want| + scale) with u = 2^-8 and scale the leaf's largest
    magnitude (< 1 passes): one rounding of each rank's share, of the
    one-device grad, and of a term as large as the leaf (a leaf fed by two
    rounded paths, e.g. a pack's weights and a per-ray row's, may cancel
    between them). Each term is needed: on this file's three kernel cases
    python -m dfnet_tpu_torch.scripts.mesh_bar_terms reads the worst error
    at 103.5 times the share term alone, 44.0 times share plus |want|, and
    0.61 times all three."""
    worst = 0.0
    for k, w in want.items():
        g, w = np.asarray(got[k], np.float64), np.asarray(w, np.float64)
        bound = 2.0 ** -8 * (sum(np.abs(s[k]) for s in shares) + np.abs(w)
                             + max(np.abs(w).max(), 1e-12))
        worst = max(worst, float((np.abs(g - w) / bound).max()))
    return worst


@pytest.mark.parametrize("case", ["perturb_off", "perturb_on", "uneven", "fp32_perturb_off",
                                  "fp32_perturb_on", "fp32_uneven"])
def test_stage1_step_world2_matches_world1(runs, case):
    """The whole batch's loss and every leaf's grad on rank 0 of world 2
    against world 1: perturb off and on (stratified jitter, sigma noise
    and importance draws taken at the batch's shape and cut to each
    rank's rays), 77 rays over 2 ranks. In float32 (the plain step) every
    grad within 1e-5 of its scale (_close: the ranks' shares count in the
    scale where they cancel). The kernel step (bf16, its plain
    versions here) returns the packed weights' grads in bf16, as the TPU
    kernel does, so each rank's share is rounded before the sum: its
    grads are held to that rounding's bound (_bf16_bar), which the
    control misses by far."""
    w1, w2 = runs[0][case], runs[1][case]
    assert w1["fused"] == w2["fused"] == (not case.startswith("fp32"))
    assert np.isclose(w2["loss"], w1["loss"], rtol=TOL, atol=0), (w2["loss"], w1["loss"])
    assert np.isclose(w2["mse"], w1["mse"], rtol=TOL, atol=0)
    if w1["fused"]:
        assert _bf16_bar(w2["grads"], w1["grads"], w2["shares"]) < 1
    else:
        assert _close(w2["grads"], w1["grads"], shares=w2["shares"]) < 1
    assert len(w2["grads"]) >= 20 and len(w2["launches"]) == len(w2["shares"]) == 2


def test_stage1_control_skipping_the_grad_reduce_fails(runs):
    """Every rank keeps its own rays' grads: rank 0's loss is its half's
    and its grads miss world 1's by far more than the bar."""
    w1, ctl = runs[0]["perturb_on"], runs[1]["control"]
    assert not np.isclose(ctl["loss"], w1["loss"], rtol=TOL, atol=0)
    assert _bf16_bar(ctl["grads"], w1["grads"], ctl["shares"]) > 10
    assert _close(ctl["grads"], w1["grads"], tol=2.0 ** -8) > 10


def test_stage1_world2_matches_jax_make_mesh_2(runs, trained):
    """On the same 128 rays at perturb 0: the port's kernel step at world 2
    against the JAX package's reference step (plain render_rays plus the
    proposal bound loss) jitted with its rays sharded over make_mesh(2),
    at the fused-train bars."""
    jcfg = jax_parse_args(SMALL[:-2] + ["--perturb", "0"], stage="nerf")
    sc = _scene()
    jm, _ = jax_create_nerfh(jcfg, jax.random.PRNGKey(0))
    jst = jax_render_settings(jcfg, sc.near, sc.far)
    shard = data_sharding(jax_make_mesh(2))
    ro, rd, target, hist = map(jnp.asarray, _jax_batch())

    @jax.jit
    def value_and_grad(p, ro, rd, target):
        ro, rd, target = (jax.lax.with_sharding_constraint(a, shard) for a in (ro, rd, target))
        hist_b = jax.lax.with_sharding_constraint(
            jnp.broadcast_to(hist[None], (ro.shape[0],) + hist.shape), shard)

        def loss_fn(p):
            out = jax_render_rays(p, jm, ro, rd, hist_b, jst, jax.random.PRNGKey(0))
            loss = sum(jax_nerfw_loss(out, target).values())
            z = out["z_vals"]
            pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
            sig = jnerfw.nerfw_apply_rays(p["proposal"], jm.cfg_proposal,
                                          jm.embed_proposal(pts), sigma_only=True)
            comp = jax_composite_nerfw(sig, z, output_transient=False, sigma_only=True)
            loss = loss + jcfg.proposal_loss_w * jax_proposal_bound_loss(
                comp["weights"], z, out["weights_fine"], out["z_all"])
            return loss, jax_img2mse(out["rgb"], target)

        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    (loss, mse), grads = value_and_grad(jax.tree.map(jnp.asarray, trained), ro, rd, target)
    want = {k: np.asarray(v) for k, v in named_leaves(jax.tree.map(np.asarray, grads))}
    got = runs[1]["jax_rays"]
    assert np.isclose(got["loss"], float(loss), rtol=1e-3), (got["loss"], float(loss))
    assert np.isclose(got["mse"], float(mse), rtol=1e-3)
    assert _close(got["grads"], want, tol=3e-2, floor=1e-7) < 1


@pytest.mark.parametrize("case", ["render", "render_plain", "prerender"])
def test_sharded_renders_match_one_device(runs, case):
    """The stage-1 eval render of a val view with each rank rendering half
    its rays (through the kernels, here their plain versions; and through
    the plain renderer when the kernels do not serve: the windowed PE), and
    FrozenNeRF's tinyimg pre-render of the train views, against world 1;
    each rank launches the kernels the one-device render launches."""
    w1, w2 = runs[0][case], runs[1][case]
    assert w1["fast"] == w2["fast"] == (case != "render_plain")
    for k in ("rgb", "disp", "acc") if case != "prerender" else ("rgb",):
        assert w2[k].shape == w1[k].shape
        np.testing.assert_allclose(w2[k], w1[k], atol=TOL, rtol=TOL, err_msg=k)
    if w1["fast"]:
        for rank_launches in w2["launches"]:
            assert rank_launches == w1["launches"][0], (w2["launches"], w1["launches"])
