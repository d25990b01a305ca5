"""The culled stage-1 train schedule (--train_cull_q, --train_fine_total,
--train_cull_warmup), port against dfnet_tpu on the CPU.

Small NeRF-H nets (D=4 W=32, 16 + 16 samples, bf16), JAX's seeded init
carried across by params_from_numpy, the same numpy rays in both packages.
JAX's fused step runs in interpret mode (fused_train.ALLOW_INTERPRET_TRAIN,
set inside a try/finally); the port's wrappers run their plain versions.
Bars are JAX's own for this schedule (tests/test_culled_render.py:239-275):
fine z within 2e-3, rgb0 / rgb / beta / acc within 5e-3, the loss within
rtol 1e-3, every gradient leaf within 3e-2 * scale + 3e-7 (scale: the
leaf's largest magnitude on either side; JAX checks the non-proposal
leaves, and the proposal's pass too). The mesh cases hold
world 2 to world 1 as tests/test_torch_port_mesh.py does."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfnet_tpu.render.fused_train as jft
from dfnet_tpu.config import parse_args as jax_parse_args
from dfnet_tpu.models import nerfw as jnerfw
from dfnet_tpu.models.factory import create_nerfh as jax_create_nerfh
from dfnet_tpu.models.factory import render_settings as jax_render_settings
from dfnet_tpu.models.losses import nerfw_loss as jax_nerfw_loss
from dfnet_tpu.models.losses import proposal_bound_loss as jax_proposal_bound_loss
from dfnet_tpu.render.volume import composite_nerfw as jax_composite_nerfw
from dfnet_tpu.render.volume import render_rays as jax_render_rays
from dfnet_tpu_torch.cli import nerf as cli
from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.models.factory import create_nerfh, render_settings
from dfnet_tpu_torch.ops import nerf_kernels as nk
from dfnet_tpu_torch.parallel import checks
from dfnet_tpu_torch.parallel.mesh import Mesh, launch
from dfnet_tpu_torch.render.fast import kernels_serve
from dfnet_tpu_torch.render.fused_train import render_rays_train_fused
from dfnet_tpu_torch.render.sampling import RowShard, sample_pdf_culled
from dfnet_tpu_torch.render.volume import render_rays
from dfnet_tpu_torch.training.checkpoints import params_from_numpy
from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer, named_leaves, stage1_loss
from test_torch_port_mesh import TOL, _bf16_bar, _close

NEAR, FAR, Q = 0.5, 3.5, 2e-3
SMALL = ["--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
         "--netdepth", "4", "--netwidth", "32", "--netdepth_fine", "4",
         "--netwidth_fine", "32", "--N_samples", "16", "--N_importance", "16",
         "--precision", "bf16"]


def _cull(nf):
    return ["--train_cull_q", str(Q), "--train_fine_total", str(nf)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """World 1 on one thread, as each rank of a mesh runs (and test workers
    do not oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fine_widths(monkeypatch):
    """The sample count of every fine sweep the port's kernel step runs,
    in call order (the wrapper wrapped, as chip_smoke.py does)."""
    seen, orig = [], nk.fine_raw_t

    def spy(packed, rays_o, rays_d, z_all, dpt, spec):
        if spec.fine:
            seen.append(z_all.shape[1])
        return orig(packed, rays_o, rays_d, z_all, dpt, spec)

    monkeypatch.setattr(nk, "fine_raw_t", spy)
    return seen


# ---------------------------------------------------------------------------
# the warmup rule
# ---------------------------------------------------------------------------

def _scene():
    return make_synthetic_scene(n_train=2, n_val=1, H=16, W=20, focal=18.0, seed=0)


def _trainer(*flags):
    cfg = parse_args(SMALL + ["--N_rand", "128", "--device", "cpu", *flags], stage="nerf")
    return NeRFTrainer(cfg, _scene())


def _adopt(dst: NeRFTrainer, src: NeRFTrainer) -> None:
    """dst takes src's params, Adam state, generators and step."""
    dst.load_params_tree({k: ({q: {r: w.detach().numpy() for r, w in v2.items()}
                               for q, v2 in v.items()} if isinstance(v, dict)
                              else v.detach().numpy()) for k, v in src.params.items()})
    dst.optimizer.load_state_dict(src.optimizer.state_dict())
    dst.gen.set_state(src.gen.get_state())
    dst.order_rng.bit_generator.state = src.order_rng.bit_generator.state
    dst.global_step = src.global_step


def test_warmup_trains_the_reference_schedule_first(monkeypatch, capsys):
    """At --train_cull_warmup 1, epoch 0 is an unculled run's epoch 0 bit
    for bit, and epoch 1 is the culled step's from epoch 0's state; the
    kernel step serves both schedules, the fine sweep at 32 samples then
    12, and one line announces the switch."""
    warm = _trainer(*_cull(12), "--train_cull_warmup", "1")
    ref, cull = _trainer(), _trainer(*_cull(12))
    widths = _fine_widths(monkeypatch)
    w0 = warm.train_epoch(0)
    assert "warmup done" not in capsys.readouterr().out
    assert set(widths) == {32}
    assert w0 == ref.train_epoch(0)
    _adopt(cull, ref)
    del widths[:]
    w1 = warm.train_epoch(1)
    assert capsys.readouterr().out.count("[nerf] warmup done") == 1
    assert set(widths) == {12}
    assert w1 == cull.train_epoch(1)
    assert w1 != ref.train_epoch(1)
    assert warm.uses_fused_train and warm.uses_fused_train_warm
    assert warm.schedule(0)[0] == ref.settings
    assert warm.schedule(1)[0] == warm.schedule(5)[0] == cull.settings


def test_no_warmup_without_culling():
    """The warmup is the culled schedule's: without --train_cull_q it
    changes nothing, and warmup 0 culls from epoch 0."""
    tr = _trainer("--train_cull_warmup", "3")
    assert tr.settings_warm is None and tr.schedule(0)[0] == tr.settings
    tr = _trainer(*_cull(12))
    assert tr.settings_warm is None and tr.schedule(0)[0].train_cull_q == Q


def test_resumed_run_past_the_warmup_trains_culled(tmp_path, monkeypatch, capsys):
    """The CLI at warmup 2: epochs 0-1 sweep 32 fine samples, a checkpoint
    at epoch 1; resumed, epochs 2-3 sweep 12, and the switch is announced
    at epoch 2."""
    flags = SMALL + _cull(12) + [
        "--train_cull_warmup", "2", "--N_rand", "64", "--basedir", str(tmp_path),
        "--expname", "nerfh", "--i_weights", "1", "--i_testset", "100", "--device", "cpu"]
    monkeypatch.setattr("dfnet_tpu_torch.data.loader.make_synthetic_scene",
                        lambda **kw: make_synthetic_scene(
                            n_train=2, n_val=1, H=12, W=16, focal=12.0, seed=kw["seed"],
                            device=kw["device"]))
    widths = _fine_widths(monkeypatch)
    cli.train(flags + ["--epochs", "1"])
    assert set(widths) == {32} and len(widths) == 4
    assert "warmup done" not in capsys.readouterr().out
    del widths[:]
    cli.train(flags + ["--epochs", "3"])
    out = capsys.readouterr().out
    assert "resumed from" in out and out.count("[nerf] warmup done") == 1
    assert set(widths) == {12} and len(widths) == 4


# ---------------------------------------------------------------------------
# the culled step against JAX's
# ---------------------------------------------------------------------------

def _setup(nf):
    """Both packages' model, settings and JAX's seeded init at this nf,
    perturb and sigma noise off, and JAX's train_ray_align rays."""
    flags = SMALL + _cull(nf) + ["--perturb", "0", "--raw_noise_std", "0"]
    jcfg = jax_parse_args(flags, stage="nerf")
    jmodel, init = jax_create_nerfh(jcfg, jax.random.PRNGKey(0))
    jst = jax_render_settings(jcfg, NEAR, FAR)
    cfg = parse_args(flags + ["--device", "cpu"], stage="nerf")
    model, _ = create_nerfh(cfg)
    st = render_settings(cfg, NEAR, FAR)
    n = jft.train_ray_align(jst, jmodel.cfg_coarse.W, jmodel.cfg_fine.W)
    rng = np.random.default_rng(nf)
    ro = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    hist = np.broadcast_to(rng.integers(0, 20, (1, jcfg.hist_bin)),
                           (n, jcfg.hist_bin)).astype(np.int32)
    target = rng.uniform(size=(n, 3)).astype(np.float32)
    return dict(jcfg=jcfg, jmodel=jmodel, jst=jst, cfg=cfg, model=model, st=st,
                params=jax.tree.map(np.asarray, init), ro=ro, rd=rd, hist=hist,
                target=target)


def _jax_step(s, fused):
    """JAX's stage-1 loss_fn (nerf_trainer.py:137-177): loss, outputs and
    grads."""
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
        return loss, out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, s["params"]))
    flat = {p: np.asarray(v) for p, v in named_leaves(jax.tree.map(np.asarray, grads))}
    return float(loss), {k: np.asarray(v) for k, v in out.items()}, flat


def _port_step(s, fused):
    params = params_from_numpy(s["params"])
    for _, leaf in named_leaves(params):
        leaf.requires_grad_(True)
    gen = torch.Generator().manual_seed(0)
    ro, rd = torch.tensor(s["ro"]), torch.tensor(s["rd"])
    hist, target = torch.tensor(s["hist"]), torch.tensor(s["target"])
    render = render_rays_train_fused if fused else render_rays
    with torch.no_grad():
        out = render(params, s["model"], ro, rd, hist, s["st"], gen)
    loss, _ = stage1_loss(params, s["model"], s["cfg"], s["st"], ro, rd, target, hist,
                          gen, fused)
    loss.backward()
    return (float(loss.detach()), {k: v.numpy() for k, v in out.items()},
            {p: t.grad.numpy() for p, t in named_leaves(params)})


@pytest.fixture(scope="module", params=[12, 32])
def steps(request):
    """Both packages' plain and fused culled steps at nf, from JAX's init."""
    s = _setup(request.param)
    assert kernels_serve(s["model"], s["st"], train=True)
    old = jft.ALLOW_INTERPRET_TRAIN
    jft.ALLOW_INTERPRET_TRAIN = True
    try:
        runs = {("jax", f): _jax_step(s, f) for f in (False, True)}
    finally:
        jft.ALLOW_INTERPRET_TRAIN = old
    runs.update({("port", f): _port_step(s, f) for f in (False, True)})
    return request.param, runs


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "kernel"])
def test_culled_step_outputs_match_jax(steps, fused):
    nf, runs = steps
    got, want = runs["port", fused][1], runs["jax", False][1]
    assert got["z_all"].shape == want["z_all"].shape == (got["rgb"].shape[0], nf)
    np.testing.assert_allclose(got["z_all"], want["z_all"], atol=2e-3)
    for k in ("rgb0", "rgb", "beta", "acc"):
        np.testing.assert_allclose(got[k], want[k], atol=5e-3, err_msg=k)
    np.testing.assert_allclose(got["z_std"], want["z_std"], atol=2e-3)
    assert (np.diff(got["z_all"], axis=-1) >= 0).all()


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "kernel"])
def test_culled_step_loss_and_grads_match_jax(steps, fused):
    """The loss against JAX's step of the same kind and JAX's plain step;
    every leaf's grad against JAX's plain step (the path JAX holds its fused
    step to), the proposal's too: its bound loss reads the fine weights and
    z at width nf, not S + I."""
    _, runs = steps
    loss, _, grads = runs["port", fused]
    for ref in {("jax", fused), ("jax", False)}:
        assert np.isclose(loss, runs[ref][0], rtol=1e-3), (loss, ref, runs[ref][0])
    want = runs["jax", False][2]
    assert sorted(grads) == sorted(want)
    checked = 0
    for path, w in want.items():
        g, w = np.asarray(grads[path], np.float64), np.asarray(w, np.float64)
        scale = max(np.abs(g).max(), np.abs(w).max(), 1e-6)
        err = np.abs(g - w).max()
        assert err < 3e-2 * scale + 3e-7, f"{path}: err {err:.2e} scale {scale:.2e}"
        assert np.abs(g).max() > 0, path
        checked += 1
    assert checked == len(grads) >= 46


# ---------------------------------------------------------------------------
# the culled draw at perturb > 0
# ---------------------------------------------------------------------------

def _placement(N=37, M=63, seed=3):
    """Sorted bins (N, M + 1) over [NEAR, FAR] and peaked weights (N, M),
    one flat row."""
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(NEAR, FAR, (N, M + 1)), -1).astype(np.float32)
    bins[:, 0], bins[:, -1] = NEAR, FAR
    c = rng.uniform(5, M - 5, (N, 1))
    w = np.exp(-0.5 * ((np.arange(M)[None] - c) / 2.0) ** 2).astype(np.float32)
    w[0] = 1.0
    return bins, w


def _interval(bins, w, q=Q):
    """Per-ray support of the culled draw: [z_lo, z_hi], the [q, 1 - q]
    quantiles of the weights' CDF padded by one mean bin and clipped to the
    bins (sample_pdf_culled's definition, in float64 numpy), widened to the
    edges of the bins that touch it (the weights' share of the mixture
    keeps those bins whole)."""
    w = w.astype(np.float64) + 1e-5
    cdf = np.concatenate([np.zeros((len(w), 1)), np.cumsum(w / w.sum(-1, keepdims=True), -1)],
                         -1)
    b = bins.astype(np.float64)
    pad = (b[:, -1] - b[:, 0]) / (b.shape[1] - 1)
    lo = np.array([np.interp(q, c, z) for c, z in zip(cdf, b)]) - pad
    hi = np.array([np.interp(1 - q, c, z) for c, z in zip(cdf, b)]) + pad
    lo = np.maximum(lo, b[:, 0])
    hi = np.maximum(np.minimum(hi, b[:, -1]), lo + 1e-4)
    lo = np.array([z[z <= v].max() for z, v in zip(b, lo)])
    hi = np.array([z[z >= v].min() for z, v in zip(b, hi)])
    return lo, hi


@pytest.mark.parametrize("nf", [12, 32])
def test_stratified_culled_draw_stays_in_the_interval(nf):
    bins, w = _placement()
    lam = 16 / 32
    gen = torch.Generator().manual_seed(nf)
    z = sample_pdf_culled(torch.tensor(bins), torch.tensor(w), nf, lam=lam, q=Q,
                          gen=gen).numpy()
    det = sample_pdf_culled(torch.tensor(bins), torch.tensor(w), nf, lam=lam, q=Q).numpy()
    assert z.shape == (len(bins), nf) and np.isfinite(z).all()
    assert (np.diff(z, axis=-1) >= 0).all()
    assert (z >= NEAR).all() and (z <= FAR).all()
    lo, hi = _interval(bins, w)
    assert (z >= lo[:, None] - 1e-5).all() and (z <= hi[:, None] + 1e-5).all()
    assert not np.allclose(z, det)                    # the jitter is drawn
    # the peaked rows' interval is a few bins wide; the flat row's the whole range
    assert np.median(hi[1:] - lo[1:]) < 0.5 * (FAR - NEAR) and hi[0] - lo[0] > 2.9


def test_culled_draw_through_a_row_shard_is_the_whole_batch_draw():
    """A RowShard draws the stratified jitter at the batch's shape and keeps
    its rows, so a rank's culled samples are world 1's rows bit for bit."""
    bins, w = map(torch.tensor, _placement())
    full = sample_pdf_culled(bins, w, 12, lam=0.5, q=Q, gen=torch.Generator().manual_seed(1))
    for lo, hi in ((0, 19), (19, 37)):
        part = sample_pdf_culled(bins[lo:hi], w[lo:hi], 12, lam=0.5, q=Q,
                                 gen=RowShard(torch.Generator().manual_seed(1), lo, hi, 37))
        assert torch.equal(part, full[lo:hi])


# ---------------------------------------------------------------------------
# the mesh: world 2 against world 1
# ---------------------------------------------------------------------------

def test_culled_step_world2_matches_world1():
    """The culled step at perturb on (stratified jitter, sigma noise and
    the culled draw at the batch's shape, cut to each rank's rays): float32
    plain steps within 1e-5 of scale at 128 and 77 rays, the kernel step
    within one bf16 rounding of each rank's share (_bf16_bar); under
    warmup 1, every rank trains the reference schedule at epoch 0 and the
    culled one at epoch 1."""
    sc = _scene()

    def cfg(*flags, **kw):
        return parse_args(SMALL + _cull(12) + ["--device", "cpu", "--N_rand", "128",
                                               "--perturb", "1", "--raw_noise_std", "0.5",
                                               *flags], stage="nerf").replace(**kw)

    fp32 = ("--precision", "fp32")
    cases = {
        "fp32": dict(cfg=cfg(*fp32, fused_train=False), idx=1),
        "fp32_uneven": dict(cfg=cfg(*fp32, fused_train=False, N_rand=77), idx=0),
        "kernel": dict(cfg=cfg(), idx=1),
        "warm_e0": dict(cfg=cfg(*fp32, "--train_cull_warmup", "1", fused_train=False),
                        idx=1, epoch=0.0),
        "warm_e1": dict(cfg=cfg(*fp32, "--train_cull_warmup", "1", fused_train=False),
                        idx=1, epoch=1.0),
        "unculled": dict(cfg=cfg(*fp32, fused_train=False, train_cull_q=0.0,
                                 train_fine_total=0), idx=1),
    }
    jobs = [("stage1_step", dict(kw, scene=sc)) for kw in cases.values()]
    mesh = Mesh(2, "cpu")
    w2 = dict(zip(cases, launch(checks.run_all, mesh, [(f, dict(kw, mesh=mesh))
                                                       for f, kw in jobs])))
    w1 = dict(zip(cases, checks.run_all(jobs)))
    for k in cases:
        assert np.isclose(w2[k]["loss"], w1[k]["loss"], rtol=TOL, atol=0), k
        assert np.isclose(w2[k]["mse"], w1[k]["mse"], rtol=TOL, atol=0), k
        assert w1[k]["fused"] == w2[k]["fused"] == (k == "kernel"), k
        if k == "kernel":
            assert _bf16_bar(w2[k]["grads"], w1[k]["grads"], w2[k]["shares"]) < 1
        else:
            assert _close(w2[k]["grads"], w1[k]["grads"], shares=w2[k]["shares"]) < 1, k
    # the warmup's epoch 0 is the unculled step, its epoch 1 the culled one
    assert w2["warm_e0"]["loss"] == pytest.approx(w1["unculled"]["loss"], rel=TOL)
    assert w2["warm_e1"]["loss"] == pytest.approx(w1["fp32"]["loss"], rel=TOL)
    assert not np.isclose(w1["fp32"]["loss"], w1["unculled"]["loss"], rtol=1e-3)
