"""Stage 2, port against dfnet_tpu on the CPU: the losses (each case of
hard-negative-mining-plus on both triplet axes, with gradients), the
callbacks, the se3 functions and the pose-error metric, the batch order
and the RVS poses, the golden stage-2 step, and one epoch of both
trainers from the same init. Tolerances are stated where they are used;
the golden step's are dfnet_tpu_torch/training/parity.py's."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfnet_tpu import pose as jpose
from dfnet_tpu.config import parse_args as jax_parse_args
from dfnet_tpu.data import scene as jscene
from dfnet_tpu.training import callbacks as jcb
from dfnet_tpu.training import feature_losses as jfl
from dfnet_tpu.training.checkpoints import save_pytree as jax_save_pytree
from dfnet_tpu.training.eval_pose import get_error_in_q as jax_error_in_q
from dfnet_tpu.training.feature_trainer import FeatureTrainer as JaxFeatureTrainer
from dfnet_tpu_torch import pose
from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.models.dfnet import dfnet_params_from_jax, dfnet_params_to_jax
from dfnet_tpu_torch.training import callbacks as cb
from dfnet_tpu_torch.training import feature_losses as fl
from dfnet_tpu_torch.training import parity
from dfnet_tpu_torch.training.eval_pose import get_error_in_q
from dfnet_tpu_torch.training.feature_trainer import FeatureTrainer
from dfnet_tpu_torch.training.nerf_trainer import named_leaves

H, W = 32, 48


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes gain nothing from intra-op threads, and test workers that
    each run a thread a core slow one another down many times over: this
    module's torch ops run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_scene(sc):
    """The JAX package's SceneData holding the port scene's arrays (the
    two packages build the same scene bit for bit)."""
    split = lambda s: jscene.Split(**dataclasses.asdict(s))
    return jscene.SceneData(train=split(sc.train), val=split(sc.val), hwf=sc.hwf,
                            near=sc.near, far=sc.far, world_setup=sc.world_setup)


def _tree(flat):
    """{'a/b/c': array} -> nested dict."""
    out = {}
    for k, v in flat.items():
        node = out
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


# ------------------------------------------------------------------ losses

def _case_inputs(case, rng):
    """(L, B, C, H, W) feature pairs whose four no-grad MSEs make `case`
    the argmin of hard-negative-mining-plus."""
    shape = (2, 4, 6, 5, 7)
    a = rng.normal(size=shape)
    noise = 0.05 * rng.normal(size=shape)
    if case == 0:       # anchor ~ rolled positive: mse(anchor, negative) ~ 0
        p = np.roll(a, -1, axis=1) + noise
    elif case == 1:     # positive ~ rolled anchor: mse(positive, anchor_neg) ~ 0
        p = np.roll(a, 1, axis=1) + noise
    elif case == 2:     # the anchor is nearly the same in every batch entry
        a = a[:, :1] + noise
        p = rng.normal(size=shape)
    else:               # the positive is
        p = a[:, :1] + noise
    return a.astype(np.float32), p.astype(np.float32)


def _jax_cases(f1, f2):
    an, n = jnp.roll(f1, 1, axis=1), jnp.roll(f2, 1, axis=1)
    return int(np.argmin([float(jfl.feature_mse(a, b)) for a, b in
                          ((f1, n), (f2, an), (f1, an), (f2, n))]))


@pytest.mark.parametrize("ref_axis", [False, True])
@pytest.mark.parametrize("case", [0, 1, 2, 3])
def test_hard_negative_mining_plus_matches_jax(case, ref_axis):
    """Value and gradients within 1e-5 (float32, one reduction in another
    order), on the JAX package's axis mapped by triplet_axis. The port's
    features are (L, B, C, H, W); JAX's (L, B, H, W, C)."""
    f1, f2 = _case_inputs(case, np.random.default_rng(case))
    j1, j2 = (jnp.asarray(x.transpose(0, 1, 3, 4, 2)) for x in (f1, f2))
    assert _jax_cases(j1, j2) == case
    jaxis = -2 if ref_axis else -1
    jval, (jg1, jg2) = jax.value_and_grad(
        lambda a, b: jfl.triplet_loss_hard_negative_mining_plus(a, b, 0.7, jaxis),
        argnums=(0, 1))(j1, j2)
    t1, t2 = (torch.tensor(x, requires_grad=True) for x in (f1, f2))
    val = fl.triplet_loss_hard_negative_mining_plus(t1, t2, 0.7, fl.triplet_axis(ref_axis))
    val.backward()
    assert float(val.detach()) == pytest.approx(float(jval), abs=1e-5)
    for g, jg in ((t1.grad, jg1), (t2.grad, jg2)):
        np.testing.assert_allclose(g.numpy().transpose(0, 1, 3, 4, 2), np.asarray(jg),
                                   atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["triplet_loss", "triplet_loss_hard_negative_mining"])
@pytest.mark.parametrize("ref_axis", [False, True])
def test_triplet_losses_match_jax(name, ref_axis):
    rng = np.random.default_rng(7)
    f1, f2 = (rng.normal(size=(3, 4, 8, 6, 5)).astype(np.float32) for _ in range(2))
    j1, j2 = (jnp.asarray(x.transpose(0, 1, 3, 4, 2)) for x in (f1, f2))
    want = getattr(jfl, name)(j1, j2, 1.0, -2 if ref_axis else -1)
    got = getattr(fl, name)(torch.tensor(f1), torch.tensor(f2), 1.0,
                            fl.triplet_axis(ref_axis))
    assert float(got) == pytest.approx(float(want), abs=1e-5)


def test_cosine_masked_pose_and_mse_losses_match_jax():
    rng = np.random.default_rng(2)
    a, b = (rng.normal(size=(16, 40)).astype(np.float32) for _ in range(2))
    for per_channel in (False, True):
        want = jfl.cosine_feature_loss(jnp.asarray(a), jnp.asarray(b), per_channel)
        got = fl.cosine_feature_loss(torch.tensor(a), torch.tensor(b), per_channel)
        assert float(got) == pytest.approx(float(want), abs=1e-6)
    mask = (rng.random((16, 40)) > 0.3).astype(np.float32)
    crit = lambda x, y: (x - y) ** 2
    want = jfl.masked_loss(crit, jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))
    got = fl.masked_loss(crit, torch.tensor(a), torch.tensor(b), torch.tensor(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert float(fl.pose_loss(torch.tensor(a), torch.tensor(b))) == pytest.approx(
        float(jfl.pose_loss(jnp.asarray(a), jnp.asarray(b))), rel=1e-6)
    bf = torch.tensor(a).bfloat16()
    assert fl.feature_mse(bf, bf + 1).dtype == torch.float32


# ------------------------------------------------------------------ callbacks

def test_callbacks_match_jax(tmp_path):
    """The same val sequence through both packages' EarlyStopping (both
    modes, multiple and single checkpoints) and ReduceLROnPlateau: the same
    files, stop epoch, best score and learning rates."""
    seq = [1.0, 0.9, 0.95, 0.9, 0.92, 0.85, 0.86, 0.87, 0.88, 0.89]
    for psnr, multiple in ((False, True), (True, False)):
        runs = []
        for pkg, sub in ((jcb, "jax"), (cb, "port")):
            d = tmp_path / f"{sub}{psnr}"
            es = pkg.EarlyStopping(str(d), patience=3, val_on_psnr=psnr)
            sched = pkg.ReduceLROnPlateau(1e-3, factor=0.5, patience=1)
            trace = []
            for epoch, v in enumerate(seq):
                es(v, {"w": np.full(2, v, np.float32)}, epoch=epoch,
                   save_multiple=multiple, save_all=psnr,
                   val_psnr=30 - 10 * v if psnr else None)
                trace.append((es.early_stop, es.counter, es.best_score, sched.step(v)))
                if es.early_stop:
                    break
            runs.append((sorted(os.listdir(d)), trace, es.val_loss_min,
                         os.path.basename(es.last_path)))
        assert runs[0] == runs[1]
        files, trace = runs[0][0], runs[0][1]
        assert trace[-1][0] and len(trace) == 9          # stopped at epoch 8
        # ties count as improvements; save_all adds each worse epoch's file
        assert files == ([f"checkpoint-{e:04d}-{30 - 10 * seq[e]:.4f}.npz"
                          for e in (2, 4, 6, 7, 8)] + ["checkpoint.npz"] if psnr else
                         [f"checkpoint-{e:04d}-{seq[e]:.4f}.npz" for e in (0, 1, 3, 5)])


# ------------------------------------------------------------------ se3 and eval

def test_se3_functions_match_jax():
    rng = np.random.default_rng(0)
    for f in ("rot_phi", "rot_theta", "rot_psi"):
        np.testing.assert_array_equal(getattr(pose, f)(0.3), getattr(jpose, f)(0.3))
    c2w = make_synthetic_scene(n_train=3, n_val=1, H=4, W=4, focal=4.0).train.poses
    np.testing.assert_array_equal(pose.perturb_rotation(c2w[0], 5.0, -3.0, 2.0),
                                  jpose.perturb_rotation(c2w[0], 5.0, -3.0, 2.0))
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    for p in c2w:
        np.testing.assert_array_equal(pose.perturb_single_render_pose(p, 0.2, 10.0, r1),
                                      jpose.perturb_single_render_pose(p, 0.2, 10.0, r2))
    assert r1.random() == r2.random()          # the same draws, in the same order
    # every branch of mat_to_quat: trace > 0, and each largest diagonal entry
    rots = [np.eye(3), pose.rot_phi(np.pi * 0.9)[:3, :3], pose.rot_theta(np.pi * 0.9)[:3, :3],
            pose.rot_psi(np.pi * 0.9)[:3, :3]]
    np.testing.assert_array_equal(pose.mat_to_quat(np.stack(rots)),
                                  jpose.mat_to_quat(np.stack(rots)))
    pred = c2w + 0.05 * rng.normal(size=c2w.shape).astype(np.float32)
    for a, b in zip(pose.pose_errors(pred, c2w), jpose.pose_errors(pred, c2w)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pose.project_rotation_svd_np(pred),
                                  jpose.project_rotation_svd_np(pred))
    t = torch.tensor(pred, requires_grad=True)
    got = pose.project_rotation_svd(t)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jpose.project_rotation_svd(jnp.asarray(pred))),
                               atol=1e-5)
    got.sum().backward()
    assert torch.isfinite(t.grad).all()


def test_get_error_in_q_matches_jax(capsys):
    """The same predictions (a fixed affine map of the images, padded to
    batches of 4 over 6 views) give both packages the same median and mean."""
    sc = make_synthetic_scene(n_train=1, n_val=6, H=8, W=8, focal=8.0, seed=2)
    proj = np.random.default_rng(3).normal(size=(8 * 8 * 3, 12)).astype(np.float32) * 0.01
    base = sc.val.poses.reshape(-1, 12)

    def fake(imgs):
        imgs = np.asarray(imgs)
        idx = [int(np.argmin(np.abs(sc.val.images - im).sum((1, 2, 3)))) for im in imgs]
        return base[idx] + imgs.reshape(len(imgs), -1) @ proj

    med, mean = get_error_in_q(lambda x: torch.tensor(fake(x)), sc.val, batch=4)
    out = capsys.readouterr().out
    jmed, jmean = jax_error_in_q(lambda x: jnp.asarray(fake(x)), _jax_scene(sc).val, batch=4)
    np.testing.assert_allclose(med, jmed, rtol=1e-6)
    np.testing.assert_allclose(mean, jmean, rtol=1e-6)
    assert f"Median error {med[0]}m and {med[1]} degrees." in out


def test_render_gt_image_matches_jax_numpy():
    """The synthetic scene's ground-truth render, in torch on the CPU, against
    the JAX package's numpy version at 24x32 (192 samples, 6 blobs) within
    1e-5; the float64 quadrature leaves them bit-equal here."""
    from dfnet_tpu.data import synthetic as jsyn
    from dfnet_tpu_torch.data import synthetic as syn

    field = syn.make_blob_field(3)
    jfield = jsyn.make_blob_field(3)
    pose = syn.sphere_poses(2, radius=2.0, seed=4)[1]
    for b in (1.0, 1.3):
        got = syn.render_gt_image(field, pose, 24, 32, 30.0, 0.5, 3.5, brightness=b)
        want = jsyn.render_gt_image(jfield, pose, 24, 32, 30.0, 0.5, 3.5, brightness=b)
        assert got.dtype == np.float32 and got.shape == (24, 32, 3)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        assert 0.05 < float(got.mean()) < 0.95


# ------------------------------------------------------------------ trainer

class _StubNeRF:
    """prerender_views as FrozenNeRF's, returning the poses' first entry as
    a grey level, so RVS renders carry the poses they were asked for."""

    def __init__(self, h, w):
        self.h, self.w, self.calls = h, w, []

    def prerender_views(self, poses, hists, log_every=10):
        self.calls.append(np.array(poses))
        return np.broadcast_to(np.asarray(poses)[:, :1, :1, None] * 0 + 0.5,
                               (len(poses), self.h, self.w, 3)).astype(np.float32)


FEATURE = ["--NeRFH", "--encode_hist", "--dataset_type", "synthetic", "--DFNet",
           "--tripletloss", "--random_view_synthesis", "--feature_precision", "fp32",
           "--featurenet_batch_size", "2", "--rvs_trans", "0.2", "--rvs_rotation", "10",
           "--d_max", "0.2", "--aot_cache_dir", ""]


def test_epoch_batches_and_rvs_poses_match_jax(tmp_path):
    sc = make_synthetic_scene(n_train=5, n_val=1, H=H, W=W, focal=40.0)
    for n, b in ((5, 2), (4, 2), (3, 4), (7, 3)):
        got = FeatureTrainer.epoch_batches(n, b, np.random.default_rng(n))
        want = JaxFeatureTrainer.epoch_batches(n, b, np.random.default_rng(n))
        assert len(got) == len(want) == -(-n // b)
        for a, c in zip(got, want):
            np.testing.assert_array_equal(a, c)
        assert sorted(set(np.concatenate(got))) == list(range(n))
    argv = FEATURE + ["--basedir", str(tmp_path)]
    t = FeatureTrainer(parse_args(argv + ["--device", "cpu"], stage="feature"), sc,
                       _StubNeRF(H, W))
    jt = JaxFeatureTrainer(jax_parse_args(argv, stage="feature"), _jax_scene(sc),
                           _StubNeRF(H, W))
    pp, views = t.rvs_refresh(np.random.default_rng(5))
    jpp, _ = jt.rvs_refresh(np.random.default_rng(5))
    np.testing.assert_array_equal(pp, jpp)
    assert pp.dtype == np.float32 and views.shape == (5, H, W, 3)
    np.testing.assert_array_equal(t.nerf.calls[0], pp)
    assert not np.array_equal(pp, sc.train.poses)


def test_golden_step_matches_jax(tmp_path):
    """The inputs of tests/test_golden_e2e.py::test_stage2_rvs_step_golden
    (the reference-replica init of torch.manual_seed(3), freezeBN, RVS,
    the reference triplet axis, weights 0.3/0.4/0.5, float32): the port's
    loss and every gradient against JAX's trainer._loss_fn under that
    test's bars; then one port step leaves the BN affine bit-identical and
    gives optax's one-step params from the same gradients within 1e-6."""
    import tempfile

    from test_torch_parity import _TorchDFNet

    from dfnet_tpu.convert import convert_dfnet_checkpoint

    torch.manual_seed(3)
    tnet = _TorchDFNet()
    with tempfile.TemporaryDirectory() as d:
        pt = os.path.join(d, "ckpt.pt")
        torch.save(tnet.state_dict(), pt)
        jp, js = convert_dfnet_checkpoint(pt)
    ckpt = str(tmp_path / "golden.npz")
    jax_save_pytree(ckpt, {"params": jp, "state": js})
    sc = make_synthetic_scene(n_train=4, n_val=2, H=H, W=W, focal=40.0)
    argv = parity.GOLDEN_FLAGS + ["--featurenet_batch_size", "4", "--basedir",
                                  str(tmp_path), "--pretrain_model_path", ckpt,
                                  "--aot_cache_dir", ""]
    jt = JaxFeatureTrainer(jax_parse_args(argv, stage="feature"), _jax_scene(sc), None)
    batch = parity.golden_batch()
    jbatch = [jnp.asarray(b.permute(0, 2, 3, 1).numpy()) if b.ndim == 4 else
              jnp.asarray(b.numpy()) for b in batch]
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jt._loss_fn(p, jt.state, *jbatch)[0])(jt.params)
    ref = dict((k, v.numpy()) for k, v in named_leaves(dfnet_params_from_jax(grads_j, {})[0]))

    t = FeatureTrainer(parse_args(argv + ["--device", "cpu"], stage="feature"), sc, None)
    loss, grads = parity.loss_and_grads(t, batch)
    ok, info = parity.golden_agreement(loss, grads, float(loss_j), ref)
    assert ok, info
    assert set(grads) == set(ref) and info["grad_err"]["adapt/2/conv2/b"] < parity.ZERO_GRAD

    lr = 1e-4
    for k in grads:
        if k.endswith(("bn_scale", "bn_bias")):
            grads[k] = np.zeros_like(grads[k])
    p0 = dfnet_params_to_jax(t.params, t.state)[0]
    g_jax = dfnet_params_to_jax(_tree(grads), {})[0]
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=lr)
    upd, _ = opt.update(g_jax, opt.init(p0), p0)
    want = optax.apply_updates(p0, upd)
    bn = t.params["adapt"]["0"]["bn_scale"].detach().clone()
    t.train_step(*batch, lr)
    assert torch.equal(t.params["adapt"]["0"]["bn_scale"], bn)
    got = dfnet_params_to_jax(t.params, t.state)[0]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)


def test_one_epoch_matches_jax(tmp_path):
    """Both trainers from the same init (JAX's, carried by a checkpoint)
    take one float32 epoch over the same targets, renders and RVS views
    with the same batch order. Step 0 runs on equal params, so its loss
    is held to the golden bar (2e-4). Every later step follows one Adam
    update each side, from gradients that agree to 2e-3 of their scale;
    Adam divides by the gradients' own magnitude, so entries whose
    gradients are near zero may take different steps of up to lr = 1e-4,
    so the later losses are held to 1e-4 relative, not to float32 rounding
    (measured: 7e-7)."""
    sc = make_synthetic_scene(n_train=4, n_val=2, H=H, W=W, focal=40.0, seed=1)
    argv = FEATURE + ["--basedir", str(tmp_path)]
    jt = JaxFeatureTrainer(jax_parse_args(argv, stage="feature"), _jax_scene(sc), None)
    ckpt = str(tmp_path / "init.npz")
    jax_save_pytree(ckpt, jt.checkpoint_tree())
    t = FeatureTrainer(parse_args(argv + ["--device", "cpu", "--pretrain_model_path",
                                          ckpt], stage="feature"), sc, None)
    rng = np.random.default_rng(9)
    rgbs = np.clip(sc.train.images * 0.9 + 0.05 * rng.random(sc.train.images.shape), 0, 1)
    views = rng.random(sc.train.images.shape).astype(np.float32)
    pp = sc.train.poses + 0.1 * rng.normal(size=sc.train.poses.shape).astype(np.float32)
    args = (sc.train.images, rgbs.astype(np.float32), views, pp)

    losses = {"jax": [], "port": []}
    j_step, t_step = jt._step, t.train_step

    def jrec(*a):
        out = j_step(*a)
        losses["jax"].append(float(out[3]))
        return out

    def trec(*a):
        out = t_step(*a)
        losses["port"].append(float(out))
        return out

    jt._step, t.train_step = jrec, trec
    jmean = jt.train_epoch(*args, np.random.default_rng(0))
    mean = t.train_epoch(*args, np.random.default_rng(0))
    assert len(losses["port"]) == len(losses["jax"]) == 2
    assert abs(losses["port"][0] - losses["jax"][0]) < parity.LOSS_TOL
    np.testing.assert_allclose(losses["port"][1:], losses["jax"][1:], rtol=1e-4)
    assert mean == pytest.approx(jmean, rel=1e-4)
    for lvl in ("0", "2"):           # train-mode BN moved the running stats alike
        np.testing.assert_allclose(t.state["adapt"][lvl]["var"].numpy(),
                                   np.asarray(jt.state["adapt"][lvl]["var"]), rtol=1e-4)
