"""Stage-2/3 losses: pose MSE, cosine feature matching, and triplet
losses with in-triplet hard-negative mining (port of
dfnet_tpu/training/feature_losses.py).

Negatives are the batch rolled by one; the *_plus variant picks the
anchor/negative arrangement with the smallest pairwise MSE among 4 cases,
computed without gradient.

Feature layout here is (L, B, C, H, W), the JAX package's is
(L, B, H, W, C). The triplet's pairwise distance reduces one axis, and
`triplet_axis` is the one place that maps the JAX package's choice onto
this layout: its default axis=-1 (C, a per-pixel feature distance) is
axis -3 here; its axis=-2 (W, the reference's reduction axis, chosen by
--triplet_ref_axis) is axis -1 here.
"""

from __future__ import annotations

import torch


def triplet_axis(ref_axis: bool) -> int:
    """The feature axis the triplet distance reduces: W (-1) for the
    reference-exact axis (the JAX package's axis=-2), else C (-3, the JAX
    package's axis=-1)."""
    return -1 if ref_axis else -3


def pose_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE over flattened 12-dim poses."""
    return torch.mean((pred - target) ** 2)


def feature_mse(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    return torch.mean((f1 - f2) ** 2, dtype=torch.float32)


def cosine_feature_loss(feature_rgb: torch.Tensor, feature_target: torch.Tensor,
                        per_channel: bool = False) -> torch.Tensor:
    """1 - mean cosine similarity of (C, H*W)-like 2-D arrays.
    per_channel=False (dim=1): similarity per channel across pixels; True
    (dim=0): per pixel across channels."""
    axis = 0 if per_channel else 1
    eps = 1e-6
    num = torch.sum(feature_rgb * feature_target, dim=axis, dtype=torch.float32)

    def norm(f):
        return torch.sqrt(torch.sum(f * f, dim=axis, dtype=torch.float32))

    den = torch.clamp(norm(feature_rgb), min=eps) * torch.clamp(norm(feature_target), min=eps)
    return 1.0 - torch.mean(num / den)


def masked_loss(criterion, f1, f2, valid_mask):
    """Loss restricted to a validity mask: f1 is masked, an elementwise
    criterion is evaluated, and the result is mask-weighted-averaged.
    criterion: (a, b) -> elementwise loss."""
    f1 = f1 * valid_mask
    loss = criterion(f1, f2)
    return torch.sum(loss * valid_mask) / torch.sum(valid_mask)


def _pairwise_distance(x, y, axis: int = -3, eps: float = 1e-6):
    """torch.nn.functional.pairwise_distance over one axis: (x - y + eps)
    in the features' dtype, its square-sum accumulated in float32."""
    return torch.sqrt(torch.sum((x - y + eps) ** 2, dim=axis, dtype=torch.float32))


def _triplet_margin(anchor, positive, negative, margin: float, axis: int = -3):
    d_ap = _pairwise_distance(anchor, positive, axis)
    d_an = _pairwise_distance(anchor, negative, axis)
    return torch.mean(torch.relu(d_ap - d_an + margin))


def triplet_loss(f1, f2, margin: float = 1.0, axis: int = -3):
    """anchor=f1 (real), positive=f2 (render), negative=f2 rolled by one
    along the batch axis (dim 1 of (L, B, ...))."""
    return _triplet_margin(f1, f2, torch.roll(f2, 1, dims=1), margin, axis)


def triplet_loss_hard_negative_mining(f1, f2, margin: float = 1.0, axis: int = -3):
    anchor, positive = f1, f2
    anchor_neg = torch.roll(f1, 1, dims=1)
    negative = torch.roll(f2, 1, dims=1)
    with torch.no_grad():
        swap = bool(feature_mse(anchor, negative) >= feature_mse(positive, anchor_neg))
    if swap:
        return _triplet_margin(positive, anchor, anchor_neg, margin, axis)
    return _triplet_margin(anchor, positive, negative, margin, axis)


def triplet_loss_hard_negative_mining_plus(f1, f2, margin: float = 1.0,
                                           axis: int = -3):
    """Four-case anchor swap: the arrangement whose (no-grad) pairwise MSE
    is smallest, and only that one, is computed and carries the gradient.
    The choice is read on the host (one sync a call); the JAX package
    takes it with lax.switch on the device."""
    anchor, positive = f1, f2
    anchor_neg = torch.roll(f1, 1, dims=1)
    negative = torch.roll(f2, 1, dims=1)
    cases = ((anchor, positive, negative), (positive, anchor, anchor_neg),
             (anchor, positive, anchor_neg), (positive, anchor, negative))
    with torch.no_grad():
        which = int(torch.argmin(torch.stack([feature_mse(a, n) for a, _, n in cases])))
    return _triplet_margin(*cases[which], margin, axis)
