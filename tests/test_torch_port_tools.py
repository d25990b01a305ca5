"""The stage-1 leftovers and the eval utilities, port against dfnet_tpu on
the CPU: view selection (every function, exactly: both are float64
numpy), the jet colormap (matplotlib's, on every value of a ramp), the
saliency and feature-grid PNGs (JAX's, pixel for pixel), the image
metrics (1e-6), the profiling hooks, --check_numerics (the port and JAX
raise on the same NaN leaf, neither without the flag), and the CLI paths:
the spiral (JAX's poses exactly, its frames within the rendered-rgb bar
3e-2), the split videos (animated PNGs of the split's frames) and
--render_feature_only (JAX's maps within the DFNet float32 bar 1e-4, the
files laid out as JAX lays them out). Small sizes: D=2 W=32 NeRFs on the
48x64 synthetic scene."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import dfnet_tpu.utils.visualization as jviz
from dfnet_tpu.cli import feature as jax_feature_cli
from dfnet_tpu.config import apply_runtime_flags as jax_runtime_flags
from dfnet_tpu.config import parse_args as jax_parse_args
from dfnet_tpu.data import scene as jscene
from dfnet_tpu.data import view_selection as jvs
from dfnet_tpu.data.loader import load_scene as jax_load_scene
from dfnet_tpu.data.synthetic import make_synthetic_scene as jax_synthetic
from dfnet_tpu.models import dfnet as jdf
from dfnet_tpu.training.checkpoints import save_pytree as jax_save_pytree
from dfnet_tpu.training.feature_trainer import FeatureTrainer as JaxFeatureTrainer
from dfnet_tpu.training.nerf_trainer import NeRFTrainer as JaxNeRFTrainer
from dfnet_tpu.utils import metrics as jmetrics
from dfnet_tpu_torch.cli import feature as feature_cli
from dfnet_tpu_torch.cli import nerf as nerf_cli
from dfnet_tpu_torch.config import apply_runtime_flags, parse_args
from dfnet_tpu_torch.data import png
from dfnet_tpu_torch.data import scene as tscene
from dfnet_tpu_torch.data import view_selection as vs
from dfnet_tpu_torch.data.loader import load_scene
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.models.factory import create_nerfh
from dfnet_tpu_torch.models.losses import to8b
from dfnet_tpu_torch.training.checkpoints import save_pytree
from dfnet_tpu_torch.training.feature_trainer import FeatureTrainer
from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer
from dfnet_tpu_torch.utils import metrics, profiling, visualization as viz

NERF = ["--config", "configs/config_synthetic.txt", "--netdepth", "2", "--netwidth", "32",
        "--netdepth_fine", "2", "--netwidth_fine", "32", "--N_samples", "8",
        "--N_importance", "8", "--render_factor", "2"]
# the synthetic stage-2 command at the NeRF's size (tests/test_torch_port_feature_cli.py)
STAGE2 = ["--dataset_type", "synthetic", "--NeRFH", "--encode_hist", "--netdepth", "2",
          "--netwidth", "32", "--netdepth_fine", "2", "--netwidth_fine", "32",
          "--N_samples", "16", "--N_importance", "16", "--expname", "nerfh",
          "--model_name", "dfnet", "--DFNet", "--featurenet_batch_size", "2",
          "--tripletloss", "--tinyimg"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes gain nothing from intra-op threads, and test workers that
    each run a thread a core slow one another down many times over: this
    module's torch ops run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ view selection

def _poses(n=12, seed=0):
    """The synthetic scene's camera poses (float64): varied views of one
    region, so the frusta overlap in part."""
    return make_synthetic_scene(n_train=n, n_val=1, seed=seed).train.poses.astype(np.float64)


def test_view_selection_matches_jax_exactly():
    poses = _poses()
    bds = np.array([0.5, 3.5])
    c2w, up = poses[3], vs._normalize(poses[:, :3, 1].sum(0))
    np.testing.assert_array_equal(vs.viewmatrix(c2w[:3, 2], up, c2w[:3, 3]),
                                  jvs.viewmatrix(c2w[:3, 2], up, c2w[:3, 3]))
    np.testing.assert_array_equal(
        np.stack(vs.render_path_spiral(c2w, up, [0.3, 0.2, 0.1], 2.0, 0.5, 2, 17)),
        np.stack(jvs.render_path_spiral(c2w, up, [0.3, 0.2, 0.1], 2.0, 0.5, 2, 17)))
    for seed in (0, 5):
        got = vs.generate_render_pose(poses, bds, rng=np.random.default_rng(seed))
        want = jvs.generate_render_pose(poses, bds, rng=np.random.default_rng(seed))
        assert len(got) == 120
        np.testing.assert_array_equal(np.stack(got), np.stack(want))
        (gp, gi), (wp, wi) = (f(poses, 0.2, 5.0, 7, rng=np.random.default_rng(seed))
                              for f in (vs.perturb_render_pose, jvs.perturb_render_pose))
        assert gi == wi
        np.testing.assert_array_equal(gp, wp)

    np.testing.assert_array_equal(vs.init_K(50.0, 3.0, 4.0), jvs.init_K(50.0, 3.0, 4.0))
    p = np.random.default_rng(1).uniform(-10, 330, (200, 3))
    np.testing.assert_array_equal(vs.is_inside_frustum(p, 320, 240),
                                  jvs.is_inside_frustum(p, 320, 240))
    K, frustum, w, h = vs.camera_frustum_initializer(bds, sample_step=0.2)
    jK, jfrustum, jw, jh = jvs.camera_frustum_initializer(bds, sample_step=0.2)
    np.testing.assert_array_equal(K, jK)
    np.testing.assert_array_equal(frustum, jfrustum)
    assert (w, h) == (jw, jh) and len(frustum) > 1000
    np.testing.assert_array_equal(
        vs.generate_sampling_frustum(0.3, 2.0, K, 292.5, 160, 120, 320, 240),
        jvs.generate_sampling_frustum(0.3, 2.0, K, 292.5, 160, 120, 320, 240))
    overlaps = [vs.compute_frustums_overlap(poses[0], poses[i], frustum, K, w, h)
                for i in range(len(poses))]
    assert overlaps == [jvs.compute_frustums_overlap(poses[0], poses[i], jfrustum, K, w, h)
                        for i in range(len(poses))]
    assert overlaps[0] == 1.0 and min(overlaps) < 0.9

    for thr in (0.5, 0.8):
        uniq = vs.fetch_unique_view_index(poses, thr, bds)
        np.testing.assert_array_equal(uniq, jvs.fetch_unique_view_index(poses, thr, bds))
        np.testing.assert_array_equal(
            vs.select_nearest_neighbor_views(poses, thr, uniq, bds, stride=2),
            jvs.select_nearest_neighbor_views(poses, thr, uniq, bds, stride=2))

    sc = make_synthetic_scene(n_train=4, n_val=5, seed=2)
    for split, gt in ((sc.train, [0, 3, 5, 7]), (sc.val, [1, 3, 4, 7, 9])):
        split.gt_idx = np.array(gt)
    jtr, jval = (jscene.Split(**dataclasses.asdict(s)) for s in (sc.train, sc.val))
    _, val = vs.remove_overlap_data(sc.train, sc.val)
    _, jv = jvs.remove_overlap_data(jtr, jval)
    assert isinstance(val, tscene.Split)
    for k in ("gt_idx", "poses", "images", "hists"):
        np.testing.assert_array_equal(getattr(val, k), getattr(jv, k))
    np.testing.assert_array_equal(val.gt_idx, [1, 4, 9])


# ------------------------------------------------------------------ visualization

def test_jet_equals_matplotlib_on_a_ramp():
    """Every value of a 4,097-point ramp on [0, 1] (0 and 1 included), of
    one on [-0.5, 1.5] (out of range: clipped as JAX clips), the float32
    rounding edges near 1 and each table step, and NaN, in float32 and
    float64."""
    import matplotlib

    edges = np.arange(257) / 256
    for dt in (np.float32, np.float64):
        r = np.concatenate([np.linspace(0, 1, 4097), np.linspace(-0.5, 1.5, 4097), edges,
                            np.nextafter(edges, -1), [np.nextafter(1, 0), np.nan]]).astype(dt)
        want = (matplotlib.colormaps["jet"](np.clip(r, 0, 1))[..., :3] * 255).astype(np.uint8)
        got = viz._jet(r)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert viz._jet(np.array([0.0, 1.0])).tolist() == [[0, 0, 127], [127, 0, 0]]


def _pil(path):
    return np.asarray(Image.open(path))


def test_saliency_and_feature_grids_equal_jax_pixel_for_pixel(tmp_path):
    rng = np.random.default_rng(3)
    nhwc = rng.normal(size=(5, 9, 11, 8)).astype(np.float32)
    nchw = rng.normal(size=(3, 4, 9, 11)).astype(np.float32)
    one = rng.normal(size=(9, 11, 6)).astype(np.float32)
    cases = [("saliancy_nhwc", "save_image_saliancy", nhwc),
             ("saliancy_nchw", "save_image_saliancy", nchw),
             ("single", "save_image_saliancy_single", one),
             ("features", "plot_features", one)]
    for name, fn, x in cases:
        getattr(viz, fn)(torch.tensor(x), str(tmp_path / f"port_{name}"))
        getattr(jviz, fn)(x, str(tmp_path / f"jax_{name}"))
        got, want = _pil(tmp_path / f"port_{name}.png"), _pil(tmp_path / f"jax_{name}.png")
        assert got.shape == want.shape and got.shape[-1] == 3
        np.testing.assert_array_equal(got, want, err_msg=name)
    # one (H, W) map, as --render_feature_only hands it: JAX's writer fails on
    # it (unbatched into _make_grid); the port writes the grid of that map
    m = one[..., 0]
    viz.save_image_saliancy_single(m, str(tmp_path / "port_map.png"))
    jviz.save_image_saliancy(m[None], str(tmp_path / "jax_map.png"))
    np.testing.assert_array_equal(_pil(tmp_path / "port_map.png"),
                                  _pil(tmp_path / "jax_map.png"))
    with pytest.raises(ValueError):
        jviz.save_image_saliancy_single(m, str(tmp_path / "jax_single_map.png"))


# ------------------------------------------------------------------ metrics, profiling

@pytest.mark.parametrize("batched", [True, False])
def test_metrics_match_jax(batched):
    """Within 1e-6: mse (the mask too); psnr relative to its value (~21 dB,
    where float32's spacing is 1.9e-6); the ssim map (reduction="none",
    equal in fact) and the ssim and dssim scalars against the float64
    mean of JAX's map: JAX's own float32 mean of that map is up to 9.8e-7
    from it here, so two float32 means of one map may differ by more than
    1e-6 between the libraries' summation orders."""
    rng = np.random.default_rng(4)
    shape = (3, 24, 30, 3) if batched else (24, 30, 3)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.08 * rng.normal(size=shape), 0, 1).astype(np.float32)
    mask = rng.random(shape) > 0.3
    ta, tb, ja, jb = torch.tensor(a), torch.tensor(b), jnp.asarray(a), jnp.asarray(b)
    assert abs(float(metrics.mse(ta, tb)) - float(jmetrics.mse(ja, jb))) <= 1e-6
    assert abs(float(metrics.mse(ta, tb, torch.tensor(mask)))
               - float(jmetrics.mse(ja, jb, mask))) <= 1e-6
    want = float(jmetrics.psnr(ja, jb))
    assert abs(float(metrics.psnr(ta, tb)) - want) <= 1e-6 * want
    s = metrics.ssim(ta, tb, reduction="none")
    js = np.asarray(jmetrics.ssim(ja, jb, reduction="none"))
    assert s.shape == ((3,) if batched else (1,)) + (14, 20, 3) == js.shape
    np.testing.assert_allclose(s.numpy(), js, atol=1e-6, rtol=0)
    exact = float(np.mean(js.astype(np.float64)))
    assert abs(float(metrics.ssim(ta, tb)) - exact) <= 1e-6
    assert abs(float(metrics.dssim(ta, tb)) - (1 - exact) / 2) <= 1e-6
    assert abs(float(jmetrics.ssim(ja, jb)) - exact) <= 1e-6
    assert float(metrics.psnr(a, b)) == pytest.approx(float(metrics.psnr(ta, tb)))


def test_step_timer_and_trace(tmp_path):
    timer = profiling.StepTimer(window=3)
    assert timer.summary() == {}
    for _ in range(4):
        with timer.step():
            torch.ones(8).sum()
    s = timer.summary()
    assert sorted(s) == ["ema_ms", "mean_ms", "p50_ms", "p95_ms", "steps", "steps_per_sec"]
    assert s["steps"] == 4 and len(timer.samples) == 3 and s["steps_per_sec"] > 0
    with profiling.device_trace(None):
        pass
    logdir = tmp_path / "trace"
    with profiling.device_trace(str(logdir)):
        with profiling.annotate("render_view"):
            torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    (name,) = os.listdir(logdir)
    with open(logdir / name) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "render_view" in names and "aten::mm" in names


# ------------------------------------------------------------------ --check_numerics

TINY = ["--NeRFH", "--encode_hist", "--dataset_type", "synthetic", "--netdepth", "2",
        "--netwidth", "16", "--netdepth_fine", "2", "--netwidth_fine", "16",
        "--N_samples", "8", "--N_importance", "8", "--N_rand", "32", "--expname", "nerfh"]


def _tiny_scenes():
    return (make_synthetic_scene(n_train=2, n_val=1, H=8, W=8, focal=8.0, seed=0),
            jax_synthetic(n_train=2, n_val=1, H=8, W=8, focal=8.0, seed=0))


@pytest.mark.parametrize("flag", [True, False])
def test_check_numerics_raises_on_a_nan_leaf_in_both_packages(tmp_path, flag):
    """One NaN entry in the fine net's first weight: under --check_numerics
    the port's stage-1 step raises FloatingPointError naming the step, and
    so does JAX's (jax_debug_nans); without the flag both run on to a NaN
    loss. Both flags are global, so each is put back in a `finally`."""
    argv = TINY + ["--basedir", str(tmp_path)] + (["--check_numerics"] if flag else [])
    sc, jsc = _tiny_scenes()
    cfg = parse_args(argv + ["--device", "cpu"], stage="nerf")
    jcfg = jax_parse_args(argv + ["--aot_cache_dir", ""], stage="nerf")
    was = torch.is_anomaly_enabled()
    try:
        with apply_runtime_flags(cfg):
            assert torch.is_anomaly_enabled() == flag
            tr = NeRFTrainer(cfg, sc)
            with torch.no_grad():
                tr.params["fine"]["xyz_0"]["w"][0, 0] = float("nan")
            if flag:
                with pytest.raises(FloatingPointError, match="epoch 0 on train image 1"):
                    tr.train_step(1, 1e-3, 0)
            else:
                loss, _ = tr.train_step(1, 1e-3, 0)
                assert np.isnan(float(loss))
        assert torch.is_anomaly_enabled() == was

        jtr = JaxNeRFTrainer(jcfg, jsc)
        jtr.params["fine"]["xyz_0"]["w"] = jtr.params["fine"]["xyz_0"]["w"].at[0, 0].set(
            jnp.nan)
        jax_runtime_flags(jcfg)             # after the NaN is set: an eager op raises too
        if flag:
            with pytest.raises(FloatingPointError):
                jtr.train_epoch(0)
        else:
            assert np.isnan(jtr.train_epoch(0)[0])
    finally:
        jax.config.update("jax_debug_nans", False)
        torch.autograd.set_detect_anomaly(was)


def test_check_numerics_holds_a_stage2_step(tmp_path):
    """The stage-2 step under the flag: a NaN in fc_pose's bias raises
    FloatingPointError before the update, and no weight moves."""
    sc = make_synthetic_scene(n_train=2, n_val=1, H=32, W=48, focal=40.0)
    cfg = parse_args(["--DFNet", "--tripletloss", "--feature_precision", "fp32",
                      "--check_numerics", "--basedir", str(tmp_path), "--device", "cpu"],
                     stage="feature")
    with apply_runtime_flags(cfg):
        t = FeatureTrainer(cfg, sc, None)
        x = t.images(sc.train.images)
        poses12 = torch.tensor(sc.train.poses.reshape(2, 12))
        t.train_step(x, x, poses12, None, None, 1e-4)
        assert t.steps == 1
        with torch.no_grad():
            t.params["fc_pose"]["b"][0] = float("nan")
        before = t.params["encoder"]["conv1_1"]["w"].detach().clone()
        with pytest.raises(FloatingPointError, match="stage-2 step 1"):
            t.train_step(x, x, poses12, None, None, 1e-4)
        assert torch.equal(t.params["encoder"]["conv1_1"]["w"], before)
    assert not torch.is_anomaly_enabled()


# ------------------------------------------------------------------ CLIs

@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """A basedir with a stage-1 checkpoint of the NeRF flags (epoch 5), the
    port's spiral and --render_test --render_video_* runs on it, and what
    they returned."""
    base = tmp_path_factory.mktemp("tools")
    argv = NERF + ["--basedir", str(base), "--device", "cpu"]
    _, params = create_nerfh(parse_args(argv), torch.Generator().manual_seed(3))
    save_pytree(str(base / "nerfh" / "000005.npz"), {"params": params}, global_step=5)
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        spiral = nerf_cli.train(argv + ["--render_pose_only"])
        p_val = nerf_cli.train(argv + ["--render_test", "--render_video_train",
                                       "--render_video_test"])
    finally:
        os.chdir(cwd)
    return base, argv, spiral, p_val


def test_spiral_poses_and_frames_match_jax(stage1, monkeypatch):
    base, argv, spiral, _ = stage1
    assert spiral == str(base / "nerfh" / "spiral_000005.png")
    frames = png.read_apng(spiral)
    assert frames.shape == (120, 24, 32, 3)
    monkeypatch.chdir(ROOT)
    cfg = parse_args(argv)
    scene = load_scene(cfg, stage="nerf")
    jcfg = jax_parse_args([a for a in argv if a not in ("--device", "cpu")]
                          + ["--aot_cache_dir", ""], stage="nerf")
    jsc = jax_load_scene(jcfg, stage="nerf")
    bds = np.array([scene.near, scene.far])
    poses = vs.generate_render_pose(scene.train.poses, bds,
                                    rng=np.random.default_rng(cfg.rng_seed))
    jposes = jvs.generate_render_pose(jsc.train.poses, np.array([jsc.near, jsc.far]),
                                      rng=np.random.default_rng(jcfg.rng_seed))
    np.testing.assert_array_equal(np.stack(poses), np.stack(jposes))

    tr = NeRFTrainer(cfg, scene)
    assert tr.try_resume() == 5
    jtr = JaxNeRFTrainer(jcfg, jsc)
    assert jtr.try_resume() == 5
    hist = scene.train.hists[0]
    for i in (0, 77):
        pose = torch.tensor(poses[i], dtype=torch.float32)
        mine = tr._render(tr.params, pose, torch.tensor(hist), 5)["rgb"].numpy()
        np.testing.assert_array_equal(frames[i], to8b(mine))      # the CLI's frame
        want = np.asarray(jtr._render(jtr.params, jnp.asarray(poses[i], jnp.float32),
                                      jnp.asarray(hist), jnp.float32(5))["rgb"])
        np.testing.assert_allclose(frames[i] / 255.0, want, atol=3e-2, rtol=0)
        np.testing.assert_allclose(mine, want, atol=3e-2, rtol=3e-2)


def test_split_videos_hold_the_split_frames(stage1):
    """Four animated PNGs at JAX's names: each rgb frame is the split's
    <j>.png, each disp frame to8b(disp / the split's largest disp) (the
    split's <j>_disp.png normalises each view by its own)."""
    base, argv, _, p_val = stage1
    exp = base / "nerfh"
    cfg = parse_args(argv)
    scene = load_scene(cfg, stage="nerf")
    tr = NeRFTrainer(cfg, scene)
    tr.try_resume()
    assert np.isfinite(p_val)
    for split, vid, pngdir in ((scene.train, "nerfh_trainset_000005_train",
                                "evaluate_train_test_000005"),
                               (scene.val, "nerfh_test_000005_test",
                                "evaluate_val_test_000005")):
        rgb = png.read_apng(str(exp / f"{vid}_rgb.png"))
        disp = png.read_apng(str(exp / f"{vid}_disp.png"))
        assert len(rgb) == len(disp) == len(split)
        d = np.stack([tr._render(tr.params, torch.tensor(p), torch.tensor(h), 5)["disp"]
                      .numpy() for p, h in zip(split.poses, split.hists)])
        np.testing.assert_array_equal(disp[..., 0], to8b(d / max(d.max(), 1e-8)))
        for j in range(len(split)):
            np.testing.assert_array_equal(rgb[j], png.read_png(str(exp / pngdir / f"{j:03d}.png")))
        with Image.open(exp / f"{vid}_rgb.png") as im:
            assert im.n_frames == len(split) and im.info["duration"] == pytest.approx(1000 / 15)


def test_render_feature_only_maps_match_jax(stage1, tmp_path, monkeypatch):
    """The port's --render_feature_only on the stage-1 NeRF and a JAX-written
    DFNet checkpoint, against JAX's render_features with the same DFNet on
    the port's renders (so that only the forward and the map are held):
    each saved map within the DFNet float32 bar (1e-4), and 2 x n_train
    PNGs at ./tmp/features/{target,rgb}/NNNN.png."""
    base = stage1[0]
    jp, js = jdf.init_dfnet_params(jax.random.PRNGKey(6))
    ckpt = str(tmp_path / "dfnet.npz")
    jax_save_pytree(ckpt, {"params": jp, "state": js})
    argv = STAGE2 + ["--basedir", str(base), "--pretrain_model_path", ckpt,
                     "--render_feature_only"]
    mine, jaxs, renders = [], [], []
    orig_save, orig_pre = feature_cli.save_image_saliancy_single, \
        FeatureTrainer.prerender_train_views

    def record(f, path):
        mine.append((f.numpy().copy(), path))
        orig_save(f, path)

    def prerender(self):
        renders.append(orig_pre(self))
        return renders[-1]

    monkeypatch.setattr(feature_cli, "save_image_saliancy_single", record)
    monkeypatch.setattr(FeatureTrainer, "prerender_train_views", prerender)
    monkeypatch.chdir(tmp_path)
    assert feature_cli.train(argv + ["--device", "cpu"]) is None
    n = len(renders[0])
    for sub in ("target", "rgb"):
        assert sorted(os.listdir(tmp_path / "tmp" / "features" / sub)) == \
            [f"{i:04d}.png" for i in range(n)]
    assert not [f for f in os.listdir(base / "dfnet") if f.endswith(".npz")]

    jcfg = jax_parse_args(argv + ["--aot_cache_dir", ""], stage="feature")
    jsc = jax_load_scene(jcfg, stage="apr")
    jt = JaxFeatureTrainer(jcfg, jsc, None)
    jt.prerender_train_views = lambda: renders[0]
    monkeypatch.setattr(jviz, "save_image_saliancy_single",
                        lambda f, path, normalize=False: jaxs.append((np.asarray(f), path)))
    jax_feature_cli.render_features(jcfg, jsc, jt, out_root="./jax_features")
    assert len(mine) == len(jaxs) == 2 * n
    for (got, path), (want, jpath) in zip(mine, jaxs):
        assert path.replace("./tmp/features", "") == jpath.replace("./jax_features", "")
        assert got.shape == want.shape == (jsc.H, jsc.W)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    first = png.read_png(str(tmp_path / "tmp" / "features" / "rgb" / "0000.png"))
    assert first.shape[2] == 3 and first.shape[0] == jsc.H + 4
