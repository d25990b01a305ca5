"""Procedural synthetic scene for tests and benchmarks.

Port of dfnet_tpu/data/synthetic.py: the same scenes from the same seed
(the ground-truth renders run in torch, on a given device). The reference
ships no test data, so we generate a 3D-consistent analytic radiance field — a handful of colored Gaussian density blobs —
and ray-march it densely to produce ground-truth images from poses on a
viewing sphere. A NeRF trained on these views must drive PSNR up; pose
regressors get exact pose labels for free. Optional per-image brightness
scaling exercises the histogram-conditioned appearance pathway.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dfnet_tpu_torch.data.color import luminance_histogram
from dfnet_tpu_torch.data.scene import SceneData, Split
from dfnet_tpu_torch.render.rays import get_rays_np


@dataclass
class BlobField:
    centers: np.ndarray   # (K,3)
    sigmas: np.ndarray    # (K,)
    amps: np.ndarray      # (K,)
    colors: np.ndarray    # (K,3)

    def density_color(self, pts: np.ndarray):
        """pts (...,3) → (sigma (...,), rgb (...,3))."""
        d2 = np.sum((pts[..., None, :] - self.centers) ** 2, -1)  # (...,K)
        g = self.amps * np.exp(-0.5 * d2 / self.sigmas**2)        # (...,K)
        sigma = g.sum(-1)
        rgb = (g[..., None] * self.colors).sum(-2) / (g.sum(-1, keepdims=True) + 1e-8)
        return sigma, np.clip(rgb, 0.0, 1.0)


def make_blob_field(seed: int = 0, K: int = 6) -> BlobField:
    rng = np.random.default_rng(seed)
    return BlobField(
        centers=rng.uniform(-0.6, 0.6, (K, 3)),
        sigmas=rng.uniform(0.12, 0.3, K),
        amps=rng.uniform(8.0, 20.0, K),
        colors=rng.uniform(0.1, 1.0, (K, 3)),
    )


def look_at_pose(campos: np.ndarray, target=np.zeros(3), up=np.array([0.0, 1.0, 0.0])):
    """c2w with camera looking along -z toward target (LLFF convention)."""
    z = campos - target
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z, campos], 1)  # (3,4)


def sphere_poses(n: int, radius: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    poses = []
    for _ in range(n):
        theta = rng.uniform(0, 2 * np.pi)
        phi = rng.uniform(np.pi / 4, np.pi / 2.2)  # upper hemisphere band
        pos = radius * np.array(
            [np.sin(phi) * np.cos(theta), np.cos(phi), np.sin(phi) * np.sin(theta)]
        )
        poses.append(look_at_pose(pos))
    return np.stack(poses).astype(np.float32)


def render_gt_image(field: BlobField, pose: np.ndarray, H: int, W: int, focal: float,
                    near: float, far: float, n_samples: int = 192,
                    brightness: float = 1.0, device="cpu") -> np.ndarray:
    """Dense-quadrature volume rendering of the analytic field, in torch on
    `device`, a few thousand pixels at a time. The types follow the numpy
    original's promotion: rays and sample positions in float32, the field
    and the quadrature in float64, the image cast to float32."""
    rays_o, rays_d = get_rays_np(H, W, focal, pose)
    dev = torch.device(device)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    centers, sigmas, amps, colors = (f64(field.centers), f64(field.sigmas),
                                     f64(field.amps), f64(field.colors))
    t = torch.as_tensor(np.linspace(near, far, n_samples, dtype=np.float32), device=dev)
    ro = torch.as_tensor(np.ascontiguousarray(rays_o), device=dev).reshape(-1, 3)
    rd = torch.as_tensor(np.ascontiguousarray(rays_d), device=dev).reshape(-1, 3)
    delta = (far - near) / (n_samples - 1)
    out = []
    for o, d in zip(ro.split(4096), rd.split(4096)):
        pts = o[:, None, :] + d[:, None, :] * t[:, None]                  # (R,S,3) f32
        d2 = torch.sum((pts[..., None, :].double() - centers) ** 2, -1)  # (R,S,K)
        g = amps * torch.exp(-0.5 * d2 / sigmas ** 2)
        sigma = g.sum(-1)
        rgb = (g[..., None] * colors).sum(-2) / (g.sum(-1, keepdim=True) + 1e-8)
        rgb = torch.clamp(rgb, 0.0, 1.0)
        alpha = 1.0 - torch.exp(-sigma * delta)
        trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
        trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
        img = ((alpha * trans)[..., None] * rgb).sum(-2)
        out.append(torch.clamp(img * brightness, 0.0, 1.0).float())
    return torch.cat(out).reshape(H, W, 3).cpu().numpy()


def make_synthetic_scene(
    n_train: int = 12,
    n_val: int = 4,
    H: int = 24,
    W: int = 32,
    focal: float = 30.0,
    near: float = 0.5,
    far: float = 3.5,
    hist_bin: int = 10,
    seed: int = 0,
    appearance_jitter: float = 0.0,
    device="cpu",
) -> SceneData:
    """The scene's views render on `device` (render_gt_image)."""
    field = make_blob_field(seed)
    rng = np.random.default_rng(seed + 1)

    def build(n, pose_seed):
        poses = sphere_poses(n, radius=2.0, seed=pose_seed)
        imgs, hists = [], []
        for p in poses:
            b = 1.0 + (rng.uniform(-appearance_jitter, appearance_jitter)
                       if appearance_jitter else 0.0)
            img = render_gt_image(field, p, H, W, focal, near, far, brightness=b,
                                  device=device)
            imgs.append(img)
            hists.append(luminance_histogram(img, hist_bin))
        return Split(
            images=np.stack(imgs),
            poses=poses,
            hists=np.stack(hists).astype(np.int32),
            gt_idx=np.arange(n),
        )

    return SceneData(
        train=build(n_train, seed + 10),
        val=build(n_val, seed + 20),
        hwf=[H, W, focal],
        near=near,
        far=far,
        world_setup={"pose_scale": 1.0, "pose_scale2": 1.0,
                     "move_all_cam_vec": [0.0, 0.0, 0.0]},
        name="synthetic",
    )
