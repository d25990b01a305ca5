"""The plain reference of DFNet for the stage-3 cell: float32 PyTorch in
the JAX package's checkpoint layout (HWIO convs, fc_pose.w (512, 12)),
independent of the program (it imports nothing of dfnet_tpu_torch, nor
JAX, nor the JAX package).

- `pose`: F's pose of one image: ImageNet normalisation, VGG16's 13 convs
  (3x3, ReLU, 2x2 max pools) to pool5, the global average, the linear pose
  head (the raw output), then R <- U V^T of the rotation block (svd_reg).
- `level0_features`: G's level-0 feature of images: conv1_1, ReLU,
  conv1_2 (the tap, before its ReLU), the adapt branch (1x1 conv, ReLU,
  5x5 conv, BatchNorm with the running statistics); at full resolution,
  so the upsample is the identity.
- `cosine_loss`: 1 - the mean over channels of each channel's cosine
  similarity across pixels.

Every convolution goes through `Conv`: float32 operands (TF32 off, the
reference), or operands rounded to fp8 e4m3 at a per-tensor scale (the
control one step below the program's bf16 DFNet).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as Fn

from benchmark.reference_nerfh import fp8_round

VGG16 = [("conv1_1", 64), ("conv1_2", 64), "M", ("conv2_1", 128), ("conv2_2", 128), "M",
         ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
         ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "M",
         ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), "M"]
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5


class Conv:
    """Same-padded convolution of NCHW x with an HWIO kernel, operands in
    `precision`: "fp32" or "fp8"."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.fp8 = precision == "fp8"

    def __call__(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        w = p["w"].permute(3, 2, 0, 1)
        if self.fp8:
            x, w = fp8_round(x), fp8_round(w)
        return Fn.conv2d(x, w, p["b"], padding=w.shape[-1] // 2)


def normalize(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) RGB in [0, 1] -> ImageNet-normalised NCHW."""
    x = images.permute(0, 3, 1, 2)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
    return (x - mean) / std


def pose(params: Dict, image: torch.Tensor, conv: Conv):
    """(raw, pose): F's (3, 4) output for one (H, W, 3) image, and that
    output with its rotation block projected by SVD."""
    x = normalize(image[None])
    for e in VGG16:
        x = Fn.max_pool2d(x, 2, 2) if e == "M" else torch.relu(conv(params["encoder"][e[0]], x))
    pooled = x.mean((2, 3))
    p12 = pooled @ params["fc_pose"]["w"] + params["fc_pose"]["b"]
    m = p12.reshape(3, 4)
    u, _, vt = torch.linalg.svd(m[:, :3], full_matrices=False)
    return m, torch.cat([u @ vt, m[:, 3:]], -1)


def level0_features(params: Dict, state: Dict, images: torch.Tensor, conv: Conv):
    """(B, 128, H, W) level-0 features of (B, H, W, 3) images."""
    enc = params["encoder"]
    x = conv(enc["conv1_2"], torch.relu(conv(enc["conv1_1"], normalize(images))))
    a, s = params["adapt"]["0"], state["adapt"]["0"]
    h = conv(a["conv2"], torch.relu(conv(a["conv1"], x)))
    inv = torch.rsqrt(s["var"] + BN_EPS)
    return ((h - s["mean"][:, None, None]) * (inv * a["bn_scale"])[:, None, None]
            + a["bn_bias"][:, None, None])


def cosine_loss(f_render: torch.Tensor, f_target: torch.Tensor) -> torch.Tensor:
    """(C, H, W) features: 1 - mean over channels of the cosine similarity
    across pixels."""
    r, t = f_render.flatten(1), f_target.flatten(1)
    num = (r * t).sum(1)
    den = r.norm(dim=1).clamp(min=1e-6) * t.norm(dim=1).clamp(min=1e-6)
    return 1.0 - torch.mean(num / den)


def upsample_bicubic(rgb: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(h, w, 3) -> (H, W, 3): bicubic (Keys, a = -0.75), half-pixel
    centres, taps clamped at the border."""
    x = Fn.interpolate(rgb.permute(2, 0, 1)[None], size=(H, W), mode="bicubic",
                       align_corners=False)
    return x[0].permute(1, 2, 0)
