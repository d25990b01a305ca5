"""The tail modules, port against dfnet_tpu on the CPU: ndc_rays (1e-6
relative, gradients reaching both inputs), the Kalman smoother (bit for
bit: both are the same float64 numpy recursion), the homography suite
(sampling bit for bit per Generator state; warps and the valid mask within
1e-5, float32 both; the mask's erosion bit for bit against cv2.erode, which
the JAX package calls) and vis_pose, drawn in numpy, against the
matplotlib figure the JAX package saves (the strip's interior within one
level a channel; each dot at matplotlib's projected position)."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import sys

import cv2
import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

from dfnet_tpu.render import rays as jrays
from dfnet_tpu.utils import homography as jhom
from dfnet_tpu.utils import kalman as jkal
from dfnet_tpu.utils import visualization as jviz
from dfnet_tpu_torch.data.png import read_png
from dfnet_tpu_torch.render import rays
from dfnet_tpu_torch.utils import homography as hom
from dfnet_tpu_torch.utils import kalman
from dfnet_tpu_torch.utils import visualization as viz

matplotlib.use("Agg")


# ------------------------------------------------------------------ ndc_rays
def test_ndc_rays_match_jax_and_carry_grads():
    rng = np.random.default_rng(0)
    H, W, focal, near = 24, 32, 28.0, 1.0
    c2w = np.concatenate([np.eye(3), rng.normal(0, 0.3, (3, 1))], 1).astype(np.float32)
    o, d = jrays.get_rays(H, W, focal, jnp.asarray(c2w))
    o = np.asarray(o) + rng.normal(0, 0.05, (H, W, 3)).astype(np.float32)
    d = np.asarray(d)
    jo, jd = jrays.ndc_rays(H, W, focal, near, jnp.asarray(o), jnp.asarray(d))
    to = torch.tensor(o, requires_grad=True)
    td = torch.tensor(d, requires_grad=True)
    po, pd = rays.ndc_rays(H, W, focal, near, to, td)
    assert po.dtype == pd.dtype == torch.float32
    for got, want in ((po, jo), (pd, jd)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    wo, wd = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    (po * torch.as_tensor(wo) + pd * torch.as_tensor(wd)).sum().backward()
    jgo, jgd = jax.grad(lambda a, b: sum(jnp.sum(x * w) for x, w in zip(
        jrays.ndc_rays(H, W, focal, near, a, b), (wo, wd))), argnums=(0, 1))(
            jnp.asarray(o), jnp.asarray(d))
    for got, want in ((to.grad, jgo), (td.grad, jgd)):
        assert torch.all(torch.isfinite(got)) and got.abs().sum() > 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ Kalman
@pytest.mark.parametrize("damping", [0.3, 1.0, 4.0])
def test_kalman_equals_jax_bit_for_bit(damping):
    rng = np.random.default_rng(int(damping * 10))
    track = np.cumsum(rng.normal(0, 0.2, (37, 3)), 0)
    np.testing.assert_array_equal(kalman.Kalman3D(track, damping),
                                  jkal.Kalman3D(track, damping))
    np.testing.assert_array_equal(kalman.Kalman1D(track[:, 1], damping),
                                  jkal.Kalman1D(track[:, 1], damping))


# ------------------------------------------------------------------ homography
FLAG_SETS = [{}, {"allow_artifacts": True, "translation_overflow": 0.1},
             {"perspective": False, "rotation": False},
             {"scaling": False, "translation": False, "n_angles": 7, "max_angle": 0.5},
             {"shift": -1, "patch_ratio": 0.8}]


@pytest.mark.parametrize("flags", range(len(FLAG_SETS)))
def test_sample_homography_equals_jax_bit_for_bit(flags):
    kw = FLAG_SETS[flags]
    shape = (2, 2) if "shift" in kw else (24, 32)
    for seed in range(4):
        got = hom.sample_homography_np(shape, rng=np.random.default_rng(seed), **kw)
        want = jhom.sample_homography_np(shape, rng=np.random.default_rng(seed), **kw)
        np.testing.assert_array_equal(got, want)


def _inverse_homographies(n: int, seed: int = 1) -> np.ndarray:
    """Inverse warps in the [-1, 1] cell coordinates inv_warp_image_batch uses."""
    rng = np.random.default_rng(seed)
    return np.linalg.inv(np.stack([jhom.sample_homography_np((2, 2), shift=-1, rng=rng)
                                   for _ in range(n)]))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("batched", [True, False])
def test_inverse_warp_matches_jax(mode, batched):
    rng = np.random.default_rng(2)
    Hinv = _inverse_homographies(3)
    img = rng.uniform(size=(3, 17, 22, 2)).astype(np.float32)
    if not batched:
        img, Hinv = img[0, ..., 0], Hinv[0]             # (H, W) and (3, 3)
    got = hom.inv_warp_image_batch(img, Hinv, mode, device="cpu")
    want = np.asarray(jhom.inv_warp_image_batch(img, Hinv, mode))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the tensor's own device is the default
    again = hom.inv_warp_image_batch(torch.as_tensor(img), torch.as_tensor(Hinv), mode)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("batched", [True, False])
def test_warp_points_matches_jax(batched):
    rng = np.random.default_rng(3)
    H = _inverse_homographies(2, seed=4)
    H = H if batched else H[0]
    pts = rng.uniform(-1, 1, (40, 2))
    got = hom.warp_points(pts, H, device="cpu")
    want = np.asarray(jhom.warp_points(pts, H))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_ellipse_element_equals_cv2(r):
    np.testing.assert_array_equal(
        hom.ellipse_element(r), cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * r, 2 * r)))


@pytest.mark.parametrize("shape", [(17, 22), (16, 24), (9, 9), (33, 8)])
def test_valid_mask_matches_jax_and_erosion_equals_cv2(shape):
    Hinv = _inverse_homographies(3, seed=5)
    # before erosion: the JAX package's mask (its erosion branch writes into
    # a read-only view of a JAX array and raises, so cv2 is the reference)
    mask = hom.compute_valid_mask(shape, Hinv, device="cpu")
    np.testing.assert_allclose(mask.numpy(), jhom.compute_valid_mask(shape, Hinv),
                               rtol=0, atol=1e-5)
    rng = np.random.default_rng(shape[0])
    field = (rng.uniform(size=(2,) + shape) > 0.3).astype(np.float32)
    field[:, 0, :] = 1.0                                    # touch every border
    field[:, :, -1] = 1.0
    for r in range(1, 5):
        el = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * r, 2 * r))
        for src in (mask.numpy(), field):
            want = np.stack([cv2.erode(m, el, iterations=1) for m in src])
            got = hom.erode(torch.as_tensor(src), r).numpy()
            np.testing.assert_array_equal(got, want)
        got = hom.compute_valid_mask(shape, Hinv, r, device="cpu").numpy()
        np.testing.assert_array_equal(
            got, np.stack([cv2.erode(m, el, iterations=1) for m in mask.numpy()]))


# ------------------------------------------------------------------ vis_pose
def _track(seed: int, n: int):
    rng = np.random.default_rng(seed)
    gt = np.cumsum(rng.normal(0, 0.1, (n, 3)), 0)
    return gt + rng.normal(0, 0.05, (n, 3)), gt, np.abs(rng.normal(0, 4, n))


def _jax_figure(pose, pose_gt):
    """The JAX package's 3-D axes (visualization.py:93-101), drawn at dpi 50."""
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 6))
    ax1 = fig.add_axes([0, 0.2, 0.9, 0.75], projection="3d")
    ax1.scatter(pose[:, 0], pose[:, 1], zs=pose[:, 2], c="r", s=9, depthshade=0)
    ax1.scatter(pose_gt[:, 0], pose_gt[:, 1], zs=pose_gt[:, 2], c="g", s=9, depthshade=0)
    ax1.view_init(30, 120)
    fig.set_dpi(50)
    fig.canvas.draw()
    return fig, ax1


@pytest.mark.parametrize("n", [7, 40, 150])
def test_vis_pose_matches_matplotlib(tmp_path, n):
    from mpl_toolkits.mplot3d import proj3d

    pose, pose_gt, theta = _track(n, n)
    path = viz.vis_pose({"pose": torch.as_tensor(pose), "pose_gt": pose_gt,
                         "theta": theta}, str(tmp_path / "port.png"))
    img = read_png(path)
    assert img.shape == (viz.FIG_H, viz.FIG_W, 3)

    # the projection: matplotlib's autoscaled limits and projected positions
    import matplotlib.pyplot as plt

    fig, ax1 = _jax_figure(pose, pose_gt)
    lims = viz.axes3d_limits(np.concatenate([pose, pose_gt]))
    np.testing.assert_allclose(lims, [ax1.get_xlim3d(), ax1.get_ylim3d(), ax1.get_zlim3d()],
                               rtol=0, atol=1e-12)
    for pts in (pose, pose_gt):
        xs, ys, _ = proj3d.proj_transform(pts[:, 0], pts[:, 1], pts[:, 2], ax1.get_proj())
        want = ax1.transData.transform(np.c_[xs, ys])
        got = viz.project_points(pts, lims)
        assert np.abs(got - want).max() < 1.0, np.abs(got - want).max()
        # the pixel under each position is a dot's (red or green, not the
        # white figure)
        r = np.clip((viz.FIG_H - want[:, 1]).astype(int), 0, viz.FIG_H - 1)
        c = np.clip(want[:, 0].astype(int), 0, viz.FIG_W - 1)
        px = img[r, c].astype(int)
        assert np.all(px.max(-1) - px.min(-1) > 60), px
    plt.close(fig)

    # the strip against the JAX package's own saved figure
    ref = tmp_path / "jax.png"
    jviz.vis_pose({"pose": pose, "pose_gt": pose_gt, "theta": theta}, str(ref))
    want = np.asarray(Image.open(ref).convert("RGB")).astype(int)
    assert want.shape == img.shape
    (bx0, bx1, by0, by1), (w, h) = viz.strip_box()
    top, left = int(viz.FIG_H - by1), int(bx0)
    # inside the frame (its left and top spines fall on the image's first
    # column and row)
    sl = (slice(top + 1, top + h), slice(left + 1, left + w))
    diff = np.abs(img[sl].astype(int) - want[sl])
    assert diff.max() <= 1, (diff.max(), np.argwhere(diff.max(-1) > 1)[:5])
    assert "matplotlib" in sys.modules     # the test's, not the port's


def test_vis_pose_imports_no_matplotlib(tmp_path):
    import subprocess

    code = ("import sys, numpy as np\n"
            "from dfnet_tpu_torch.utils.visualization import vis_pose\n"
            "r = np.random.default_rng(0)\n"
            "p = vis_pose({'pose': r.normal(size=(5, 3)), 'pose_gt': r.normal(size=(5, 3)),"
            " 'theta': r.uniform(0, 20, 5)}, sys.argv[1])\n"
            "assert 'matplotlib' not in sys.modules\n"
            "print(p)\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "v.png")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert read_png(str(tmp_path / "v.png")).shape == (300, 400, 3)
