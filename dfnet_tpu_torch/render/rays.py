"""Pinhole ray generation (LLFF/NeRF camera convention).

Pixel (i=x, j=y) maps to the camera-frame direction
  [(i - W/2)/f, -(j - H/2)/f, -1]
rotated into the world frame by c2w[:3,:3]; all origins are c2w[:3,3].
Counterpart of dfnet_tpu/render/rays.py, ndc_rays included.
"""

from __future__ import annotations

import numpy as np
import torch


def get_rays(H: int, W: int, focal: float, c2w: torch.Tensor):
    """Torch ray generation on c2w's device. c2w: (3,4). Returns
    (rays_o, rays_d), each (H,W,3) float32."""
    c2w = c2w.to(torch.float32)
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=c2w.device),
        torch.arange(W, dtype=torch.float32, device=c2w.device),
        indexing="ij")
    dirs = torch.stack(
        [(i - W * 0.5) / focal, -(j - H * 0.5) / focal, -torch.ones_like(i)], -1)
    rays_d = torch.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_np(H: int, W: int, focal: float, c2w: np.ndarray):
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy"
    )
    dirs = np.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal, -np.ones_like(i)], -1)
    rays_d = np.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o: torch.Tensor,
             rays_d: torch.Tensor):
    """Shift ray origins to the near plane and project origins and
    directions to NDC (forward-facing scenes only; 7-Scenes and Cambridge
    run with no_ndc, and neither package calls this). Float32 torch on the
    inputs' device, differentiable in rays_o and rays_d."""
    rays_o, rays_d = rays_o.to(torch.float32), rays_d.to(torch.float32)
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox, oy, oz = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    dx, dy, dz = rays_d[..., 0], rays_d[..., 1], rays_d[..., 2]
    o0 = -1.0 / (W / (2.0 * focal)) * ox / oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy / oz
    o2 = 1.0 + 2.0 * near / oz
    d0 = -1.0 / (W / (2.0 * focal)) * (dx / dz - ox / oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (dy / dz - oy / oz)
    d2 = -2.0 * near / oz
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)
