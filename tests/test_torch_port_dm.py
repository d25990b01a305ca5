"""Stage 3 (DFNet_dm), port against dfnet_tpu on the CPU: the level
selection, the per-image DM loss and its gradients through the plain
renderer into F (with a detached-render control that must fail), the val
metrics, the photometric and feature-NeRF variants, the batched step
against the per-image step, and a self-supervised run.

Both packages load the same JAX-written checkpoints: a NeRF-H of D=2,
W=32 with 10+10 samples from JAX's create_nerfh (rendered at 12x16 under
tinyimg and upsampled to the 48x64 synthetic views), and DFNet at full
width from JAX's init, its pose head's bias set by parity.dm_pose_bias so
that F predicts near-rotations with distinct singular values. The scene
has a non-identity world setup. Tolerances are stated where they are
used; the float32 gradient bars are dfnet_tpu_torch/training/parity.py's."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfnet_tpu.config import parse_args as jax_parse_args
from dfnet_tpu.models.dfnet import init_dfnet_params as jax_init_dfnet
from dfnet_tpu.models.factory import create_nerfh as jax_create_nerfh
from dfnet_tpu.training import dm_trainer as jdm
from dfnet_tpu.training.checkpoints import save_pytree as jax_save_pytree
from dfnet_tpu.training.nerf_renderer import FrozenNeRF as JaxFrozenNeRF
from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.models.dfnet import dfnet_params_from_jax
from dfnet_tpu_torch.training import parity
from dfnet_tpu_torch.training.checkpoints import params_from_numpy
from dfnet_tpu_torch.training.dm_trainer import DMTrainer, select_levels_for_loss
from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF
from dfnet_tpu_torch.training.nerf_trainer import named_leaves
from test_torch_port_feature import _jax_scene

H, W = 48, 64
JAX_ONLY = ["--aot_cache_dir", "", "--compilation_cache_dir", ""]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes gain nothing from intra-op threads, and test workers that
    each run a thread a core slow one another down many times over: this
    module's torch ops run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """A basedir with the JAX-written NeRF checkpoint, the DFNet checkpoint
    and the scene (6 train, 3 val views)."""
    base = tmp_path_factory.mktemp("dm")
    sc = make_synthetic_scene(n_train=6, n_val=3, H=H, W=W, focal=60.0, seed=0)
    sc.world_setup = parity.DM_WORLD
    jcfg = jax_parse_args(parity.DM_FLAGS + JAX_ONLY + ["--basedir", str(base)],
                          stage="nerf")
    nerf = jax.jit(lambda k: jax_create_nerfh(jcfg, k)[1])(jax.random.PRNGKey(0))
    jax_save_pytree(str(base / "nerfh" / "000005.npz"), {"params": nerf})
    params, state = jax.jit(jax_init_dfnet)(jax.random.PRNGKey(1))
    params["fc_pose"]["b"] = jnp.asarray(parity.dm_pose_bias(sc.train.poses[0]))
    ckpt = str(base / "dfnet.npz")
    jax_save_pytree(ckpt, {"params": params, "state": state})
    return base, ckpt, sc


def _pair(exp, *flags):
    """JAX's and the port's DMTrainer on the same checkpoints and flags."""
    base, ckpt, sc = exp
    argv = parity.DM_FLAGS + ["--basedir", str(base), "--pretrain_model_path", ckpt,
                              *flags]
    jcfg = jax_parse_args(argv + JAX_ONLY, stage="dm")
    js = _jax_scene(sc)
    jnerf = JaxFrozenNeRF.from_experiment(jcfg.replace(tinyimg=True, tinyscale=4.0),
                                          js.hwf, js.near, js.far, js.world_setup)
    cfg = parse_args(argv + ["--device", "cpu"], stage="dm")
    nerf = FrozenNeRF.from_experiment(cfg.replace(tinyimg=True, tinyscale=4.0), sc.hwf,
                                      sc.near, sc.far, sc.world_setup)
    return jdm.DMTrainer(jcfg, js, jnerf), DMTrainer(cfg, sc, nerf)


@pytest.fixture(scope="module")
def shared(exp):
    """_pair by flags, one pair for the tests that leave their trainers as
    they found them, with JAX's loss and gradients of train view 1
    (_jax_grads) computed once a pair."""
    cache = {}

    def get(*flags):
        if flags not in cache:
            jt, t = _pair(exp, *flags)
            cache[flags] = jt, t, _jax_grads(jt, *_view(exp[2], 1))
        return cache[flags]

    return get


def _view(sc, i, split="train"):
    s = getattr(sc, split)
    return s.images[i], s.poses[i].reshape(1, 12), s.hists[i]


def _jax_grads(jt, image, pose12, hist):
    """JAX's DM loss and F's gradients by the port's leaf paths, eagerly as
    the golden stage-2 test runs it (jitted, XLA's CPU convolutions depart
    from both the eager form and the port by up to 1.5e-2 of a leaf's
    scale at these inputs: G's ReLUs decided the other way)."""
    (loss, psnr), g = jax.value_and_grad(
        lambda p: jt._loss_fn(p, jt.nerf.params, jt.feat_params, jnp.asarray(image),
                              jnp.asarray(pose12), jnp.asarray(hist)),
        has_aux=True)(jt.params)
    grads = {k: v.numpy() for k, v in named_leaves(dfnet_params_from_jax(g, {})[0])}
    return float(loss), float(psnr), grads


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("levels", [[0], [0, 2]])
def test_select_levels_matches_jax(levels):
    """Exactly equal: the port's (L, B, C, H, W) features and JAX's
    (L, B, H, W, C) give the same level-major (B, L'*C, H*W)."""
    f = np.random.default_rng(0).normal(size=(3, 2, 5, 4, 6)).astype(np.float32)
    want = jdm.select_levels_for_loss(jnp.asarray(f.transpose(0, 1, 3, 4, 2)), levels)
    got = select_levels_for_loss(torch.tensor(f), levels)
    assert got.shape == (2, 5 * len(levels), 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ (b), (c)

@pytest.mark.parametrize("w", ["0.2,0.3,0.5", "0,0,1"])
def test_dm_loss_and_grads_match_jax(exp, shared, w):
    """The per-image DM loss at float32 with svd_reg: loss within 2e-4,
    the predicted pose within 1e-4, dL/dpose (fc_pose/b's gradient) within
    2e-3 of its scale and F's gradients on every leaf under parity's
    float32 bars; F's adapt leaves get no gradient on either side. The
    predicted rotation block's singular values, measured: 1.1510, 0.9989,
    0.8542 (distinct: the SVD backward is well defined there)."""
    jt, t, (jloss, jpsnr, ref) = shared("--combine_loss_w", w)
    view = _view(exp[2], 1)
    pose = t.predict_poses(t.params, torch.tensor(view[0])[None]).detach()
    jpose = np.asarray(jt._predict_pose(jt.params, jnp.asarray(view[0])))
    np.testing.assert_allclose(pose.numpy(), jpose, atol=1e-4, rtol=0)
    sv = torch.linalg.svdvals(t.predict12(torch.tensor(view[0])[None]).reshape(3, 4)[:, :3])
    np.testing.assert_allclose(sv.numpy(), [1.1510, 0.9989, 0.8542], atol=1e-3)

    loss, psnr, grads, _ = parity.dm_loss_and_grads(t, *view)
    ok, info = parity.dm_agreement(loss, grads, jloss, ref)
    assert ok, info
    assert info["adapt_max"] == 0.0
    assert psnr == pytest.approx(jpsnr, abs=1e-3)
    scale = float(np.abs(ref["fc_pose/b"]).max())
    assert scale > 1e-3
    assert np.abs(grads["fc_pose/b"] - ref["fc_pose/b"]).max() < parity.GRAD_TOL * scale


def test_detached_render_control_fails_the_bars(exp, shared):
    """With the render detached before G, the [0, 0, 1] loss reaches F only
    through zero-weighted terms: every gradient of F is zero, and the bars
    of the test above reject it. So the gradient there crosses the
    renderer."""
    _, t, (jloss, _, ref) = shared("--combine_loss_w", "0,0,1")
    render = t.render
    t.render = lambda *a: render(*a).detach()
    try:
        loss, _, grads, _ = parity.dm_loss_and_grads(t, *_view(exp[2], 1))
    finally:
        del t.render
    assert abs(loss - jloss) < parity.LOSS_TOL          # the forward is unchanged
    assert all(not g.any() for g in grads.values())
    ok, _ = parity.dm_agreement(loss, grads, jloss, ref)
    assert not ok


# ------------------------------------------------------------------ (d)

def test_eval_epoch_matches_jax(exp):
    """At N_rand = H*W both draws cover every pixel, so the val PSNR does
    not depend on the order: pose MSE within 1e-5 relative, PSNR within
    1e-2 dB (float32 renders of the same rays)."""
    jt, t = _pair(exp, "--N_rand", str(H * W))
    jloss, jpsnr = jt.eval_epoch()
    loss, psnr = t.eval_epoch()
    assert loss == pytest.approx(jloss, rel=1e-5)
    assert psnr == pytest.approx(jpsnr, abs=1e-2)
    assert 5.0 < psnr < 40.0


# ------------------------------------------------------------------ (e)

def _jax_step_loss(jt, step, view, key):
    image, pose12, hist = view
    out = step(jax.tree.map(jnp.copy, jt.params), jt.optimizer.init(jt.params),
               jnp.asarray(image), jnp.asarray(pose12), jnp.asarray(hist), key)
    return float(out[2]), float(out[3])


def test_photometric_loss_matches_jax(exp):
    """JAX's photometric step on the rays of its own jax.random.permutation
    draw, the port's loss function on those indices: loss within 2e-4,
    PSNR within 1e-2 dB; the port's step updates F and returns that loss."""
    jt, t = _pair(exp, "--combine_loss_w", "0.3,0.7")
    view = _view(exp[2], 2)
    key = jax.random.PRNGKey(5)
    sel = torch.tensor(np.asarray(jax.random.permutation(key, H * W)[:128]))
    jloss, jpsnr = _jax_step_loss(jt, jt.build_photometric_step(), view, key)
    args = [torch.tensor(a) for a in view] + [sel]
    loss, psnr = (v.detach() for v in t.photometric_loss_fn(t.params, *args))
    assert abs(float(loss) - jloss) < parity.LOSS_TOL
    assert float(psnr) == pytest.approx(jpsnr, abs=1e-2)
    b = t.params["fc_pose"]["b"].detach().clone()
    step_loss, _ = t.build_photometric_step()(*args)
    assert float(step_loss) == float(loss)
    assert not torch.equal(t.params["fc_pose"]["b"], b)


def test_feature_nerf_loss_matches_jax(exp, shared):
    """The feature-field variant (a NeRF of 3 + 128 output channels, JAX's
    random init carried to the port) at the same ray indices: loss within
    2e-4, PSNR within 1e-2 dB."""
    jt, t, _ = shared("--combine_loss_w", "0.2,0.3,0.5")
    sc = exp[2]
    jcfg = jt.cfg.replace(out_channel_size=3 + 128, no_reload=True)
    jnerf = JaxFrozenNeRF(jcfg, sc.hwf, sc.near, sc.far, parity.DM_WORLD)
    nerf = FrozenNeRF(t.cfg.replace(out_channel_size=3 + 128), sc.hwf, sc.near, sc.far,
                      parity.DM_WORLD,
                      params=params_from_numpy(jax.tree.map(np.asarray, jnerf.params)))
    view = _view(sc, 3)
    key = jax.random.PRNGKey(6)
    sel = torch.tensor(np.asarray(jax.random.permutation(key, H * W)[:128]))
    jloss, jpsnr = _jax_step_loss(jt, jt.build_feature_nerf_step(jnerf), view, key)
    loss, psnr = t.feature_nerf_loss_fn(nerf, t.params, *[torch.tensor(a) for a in view],
                                        sel)
    assert abs(float(loss) - jloss) < parity.LOSS_TOL
    assert float(psnr) == pytest.approx(jpsnr, abs=1e-2)


# ------------------------------------------------------------------ (f), (g)

def _grads_of(t, fn):
    for _, p in t._named:
        p.grad = None
    fn(t.params).backward()
    out = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
           for k, p in t._named}
    for _, p in t._named:
        p.grad = None
    return out


def test_batched_step_matches_per_image_step(exp):
    """K=2 (one flattened ray stream, one DFNet call each for F and G)
    against the port's per-image loss: each loss within 5e-5, the batched
    gradient within 5e-3 of each leaf's scale (floored at 1e-3 of the
    largest) of the per-image gradients' mean, float32 (the bars of JAX's
    test_dm_batched_step_parity). Then an epoch of 6 images at K=4 runs
    one 4-image batch and a 2-image per-image tail, each image once."""
    _, t = _pair(exp, "--combine_loss_w", "0.2,0.3,0.5", "--dm_batch_size", "2")
    sc = exp[2]
    imgs = torch.tensor(sc.train.images[:2])
    p12 = torch.tensor(sc.train.poses[:2].reshape(2, 12))
    hists = torch.tensor(sc.train.hists[:2])
    args = (t.nerf.params, t.feat_params)
    mean, (losses, psnrs) = t.batched_loss_fn(t.params, *args, imgs, p12, hists)
    assert float(mean) == pytest.approx(float(losses.mean()), rel=1e-6)
    for i in range(2):
        li, pi = t.loss_fn(t.params, *args, imgs[i], p12[i:i + 1], hists[i])
        assert abs(float(li) - float(losses[i])) < 5e-5
        assert abs(float(pi) - float(psnrs[i])) < 5e-3
    gb = _grads_of(t, lambda p: t.batched_loss_fn(p, *args, imgs, p12, hists)[0])
    g = [_grads_of(t, lambda p: t.loss_fn(p, *args, imgs[i], p12[i:i + 1], hists[i])[0])
         for i in range(2)]
    gm = {k: (g[0][k] + g[1][k]) / 2 for k in gb}
    gscale = max(float(v.abs().max()) for v in gm.values())
    for k in gb:
        tol = 5e-3 * max(float(gm[k].abs().max()), 1e-3 * gscale)
        assert float((gb[k] - gm[k]).abs().max()) < tol, k

    t.cfg = t.cfg.replace(dm_batch_size=4)
    seen, step = [], t.train_step

    def spy(images, poses12, hists):
        seen.append(poses12.numpy())
        return step(images, poses12, hists)

    t.train_step = spy
    loss, psnr = t.train_epoch(np.random.default_rng(0))
    assert [len(s) for s in seen] == [4, 1, 1]
    rows = np.concatenate(seen)
    order = [int(np.argmin(np.abs(sc.train.poses.reshape(6, 12) - r).sum(1))) for r in rows]
    assert sorted(order) == list(range(6))
    assert np.isfinite(loss) and np.isfinite(psnr)


def test_self_supervised_run_lowers_the_train_loss(exp):
    """combine_loss_w [0, 0, 1] (the shipped stage-3 weights: no pose
    label is read), five epochs: some later epoch's mean train loss is
    below epoch 0's (JAX's test_dm_training_self_supervised), every epoch
    finite, F's params move and G's and the NeRF's stay as they were."""
    _, t = _pair(exp, "--combine_loss_w", "0,0,1")
    g0 = [v.clone() for _, v in named_leaves(t.feat_params)]
    n0 = [v.clone() for _, v in named_leaves(t.nerf.params)]
    f0 = [v.detach().clone() for _, v in t._named]
    rng = np.random.default_rng(0)
    losses = [t.train_epoch(rng) for _ in range(5)]
    assert np.all(np.isfinite(losses))
    assert min(l for l, _ in losses[1:]) < losses[0][0]
    assert all(torch.equal(a, b) for a, (_, b) in zip(g0, named_leaves(t.feat_params)))
    assert all(torch.equal(a, b) for a, (_, b) in zip(n0, named_leaves(t.nerf.params)))
    assert not all(torch.equal(a, b) for a, (_, b) in zip(f0, t._named))
    assert not any(v.requires_grad for _, v in named_leaves(t.feat_params))
    assert not any(v.requires_grad for _, v in named_leaves(t.nerf.params))
