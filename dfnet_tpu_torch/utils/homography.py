"""Homography augmentation suite: random homography sampling, point
warping, inverse image warping and valid-region masks (port of
dfnet_tpu/utils/homography.py; the reference's utils.py:125-331,
SuperPoint-style augmentation that its entry points do not call).

Sampling stays host-side numpy in float64, so one `np.random.Generator`
state gives both packages the same homography bit for bit. Warping is
torch in float32 on the caller's device (the device of the tensors passed
in, else `device`, the GPU by default), with the JAX package's NHWC
interface: a grid_sample-equivalent bilinear sampler with
align_corners=True and zero padding, written as its four-corner gather.
The valid mask's erosion is cv2.erode's with a MORPH_ELLIPSE element,
done in torch, so the port needs no cv2.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dfnet_tpu_torch.device import resolve_device


def _get_perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3x3 homography mapping 4 src points to 4 dst points
    (cv2.getPerspectiveTransform equivalent, solved as an 8x8 system)."""
    A = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        A[2 * i] = [x, y, 1, 0, 0, 0, -u * x, -u * y]
        A[2 * i + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y]
        b[2 * i] = u
        b[2 * i + 1] = v
    h = np.linalg.solve(A, b)
    return np.concatenate([h, [1.0]]).reshape(3, 3)


def sample_homography_np(
    shape, shift=0, perspective=True, scaling=True, rotation=True,
    translation=True, n_scales=5, n_angles=25, scaling_amplitude=0.1,
    perspective_amplitude_x=0.1, perspective_amplitude_y=0.1,
    patch_ratio=0.5, max_angle=np.pi / 2, allow_artifacts=False,
    translation_overflow=0.0, rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Random valid homography between a centered patch and a perturbed
    (perspective/scale/rotation/translation) projection of it."""
    rng = rng or np.random.default_rng()
    pts1 = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, 0.0]])
    margin = (1 - patch_ratio) / 2
    pts2 = margin + np.array([[0, 0], [0, patch_ratio],
                              [patch_ratio, patch_ratio], [patch_ratio, 0]])

    def trunc_normal(scale, size=1):
        # truncated normal in ±2σ
        out = rng.normal(0.0, scale, size)
        return np.clip(out, -2 * scale, 2 * scale)

    if perspective:
        if not allow_artifacts:
            perspective_amplitude_x = min(perspective_amplitude_x, margin)
            perspective_amplitude_y = min(perspective_amplitude_y, margin)
        pd = trunc_normal(perspective_amplitude_y / 2)
        hl = trunc_normal(perspective_amplitude_x / 2)
        hr = trunc_normal(perspective_amplitude_x / 2)
        pts2 += np.array([[hl, pd], [hl, -pd], [hr, pd], [hr, -pd]]).squeeze(-1)

    if scaling:
        scales = np.concatenate(
            [[1.0], 1.0 + trunc_normal(scaling_amplitude / 2, n_scales)])
        center = pts2.mean(0, keepdims=True)
        scaled = (pts2 - center)[None] * scales[:, None, None] + center
        if allow_artifacts:
            valid = np.arange(len(scales))
        else:
            ok = ((scaled >= 0.0) & (scaled < 1.0)).all((1, 2))
            valid = np.where(ok)[0]
        pts2 = scaled[rng.choice(valid)]

    if translation:
        t_min, t_max = pts2.min(0), (1 - pts2).min(0)
        if allow_artifacts:
            t_min = t_min + translation_overflow
            t_max = t_max + translation_overflow
        pts2 += np.array([rng.uniform(-t_min[0], t_max[0]),
                          rng.uniform(-t_min[1], t_max[1])])

    if rotation:
        angles = np.concatenate(
            [np.linspace(-max_angle, max_angle, n_angles), [0.0]])
        center = pts2.mean(0, keepdims=True)
        rot = np.stack([np.cos(angles), -np.sin(angles),
                        np.sin(angles), np.cos(angles)], 1).reshape(-1, 2, 2)
        rotated = (pts2 - center)[None] @ rot + center
        if allow_artifacts:
            valid = np.arange(n_angles)
        else:
            ok = ((rotated >= 0.0) & (rotated < 1.0)).all((1, 2))
            valid = np.where(ok)[0]
        pts2 = rotated[rng.choice(valid)]

    shape = np.array(shape)[::-1]  # [y, x] → [x, y]
    pts1 = pts1 * shape[None]
    pts2 = pts2 * shape[None]
    return _get_perspective_transform(
        (pts1 + shift).astype(np.float32), (pts2 + shift).astype(np.float32))


def _device(*xs, device=None) -> torch.device:
    """The device of the first tensor among xs, else resolve_device(device)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(device)


def _f32(x, device) -> torch.Tensor:
    """x as float32 on device; float64 input is rounded to float32 as
    jnp.asarray does with x64 off."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def warp_points(points, homographies, device=None) -> torch.Tensor:
    """points (N, 2 xy) warped by homographies (3, 3) or (B, 3, 3) →
    (N, 2) or (B, N, 2), float32."""
    dev = _device(homographies, points, device=device)
    H = _f32(homographies, dev)
    no_batch = H.ndim == 2
    H = H[None] if no_batch else H
    pts = _f32(points, dev)
    pts = torch.cat([pts, torch.ones_like(pts[:, :1])], 1)
    warped = torch.einsum("bij,nj->bni", H, pts)
    warped = warped[..., :2] / warped[..., 2:]
    return warped[0] if no_batch else warped


def _grid_sample_bilinear(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C); coords (B, h, w, 2) in [-1, 1] (x, y),
    align_corners=True, zero padding: F.grid_sample's arithmetic as the
    four-corner gather of the JAX package."""
    B, H, W, C = img.shape
    x = (coords[..., 0] + 1.0) * (W - 1) / 2.0
    y = (coords[..., 1] + 1.0) * (H - 1) / 2.0
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1, y0 + 1
    flat = img.reshape(B, H * W, C)

    def gather(yy, xx):
        yi = yy.clamp(0, H - 1).to(torch.int64)
        xi = xx.clamp(0, W - 1).to(torch.int64)
        valid = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
        idx = (yi * W + xi).reshape(B, -1, 1).expand(-1, -1, C)
        out = torch.gather(flat, 1, idx).reshape(*yy.shape, C)
        return out * valid[..., None]

    wa = (x1 - x) * (y1 - y)
    wb = (x1 - x) * (y - y0)
    wc = (x - x0) * (y1 - y)
    wd = (x - x0) * (y - y0)
    return (gather(y0, x0) * wa[..., None] + gather(y1, x0) * wb[..., None]
            + gather(y0, x1) * wc[..., None] + gather(y1, x1) * wd[..., None])


def inv_warp_image_batch(img, mat_homo_inv, mode: str = "bilinear",
                         device=None) -> torch.Tensor:
    """img (B, H, W, C), (H, W) or (H, W, C); mat_homo_inv (B, 3, 3) or
    (3, 3). Returns the inverse-warped (B, H, W, C) float32 batch; mode
    "nearest" rounds the source pixel half to even (jnp.round)."""
    dev = _device(img, mat_homo_inv, device=device)
    img = _f32(img, dev)
    if img.ndim == 2:
        img = img[None, ..., None]
    elif img.ndim == 3:
        img = img[None]
    H_mat = _f32(mat_homo_inv, dev)
    if H_mat.ndim == 2:
        H_mat = H_mat[None]
    B, H, W, C = img.shape
    xs = torch.linspace(-1, 1, W, device=dev)
    ys = torch.linspace(-1, 1, H, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")                 # (H, W)
    cells = torch.stack([gx, gy], -1).reshape(-1, 2)               # (H*W, 2) xy
    src = warp_points(cells, H_mat).reshape(B, H, W, 2)
    if mode == "nearest":
        half = torch.tensor([(W - 1) / 2, (H - 1) / 2], dtype=torch.float32, device=dev)
        src = torch.round(src * half) / half
    return _grid_sample_bilinear(img, src)


def ellipse_element(erosion_radius: int) -> np.ndarray:
    """cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2r, 2r)) as uint8,
    computed as OpenCV does (its rows' half-widths rounded half to even),
    not as a disc formula."""
    k = 2 * erosion_radius
    r = c = k // 2
    inv_r2 = 1.0 / (r * r)
    elem = np.zeros((k, k), np.uint8)
    for i in range(k):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
            elem[i, max(c - dx, 0):min(c + dx + 1, k)] = 1
    return elem


def erode(mask: torch.Tensor, erosion_radius: int) -> torch.Tensor:
    """cv2.erode(mask[i], ellipse_element(r)) for each (H, W) map of a
    (B, H, W) batch: the minimum over the element anchored at its centre
    (r, r), with cv2's default border (the largest value, so the image
    edge erodes nothing)."""
    elem = ellipse_element(erosion_radius)
    k, r = elem.shape[0], erosion_radius
    H, W = mask.shape[-2:]
    padded = torch.nn.functional.pad(mask, (r, k - 1 - r, r, k - 1 - r),
                                     value=float("inf"))
    out = None
    for i, j in zip(*np.nonzero(elem)):
        win = padded[..., i:i + H, j:j + W]
        out = win if out is None else torch.minimum(out, win)
    return out.contiguous()


def compute_valid_mask(image_shape, inv_homography, erosion_radius: int = 0,
                       device=None) -> torch.Tensor:
    """(B, H, W) float32 mask of the pixels the inverse warp takes from
    inside the image (nearest mode), eroded by ellipse_element(r) when
    erosion_radius > 0. A tensor on the homography's device (the JAX
    package returns numpy)."""
    dev = _device(inv_homography, device=device)
    Hm = _f32(inv_homography, dev)
    if Hm.ndim == 2:
        Hm = Hm[None]
    ones = torch.ones((Hm.shape[0], image_shape[0], image_shape[1], 1), device=dev)
    mask = inv_warp_image_batch(ones, Hm, mode="nearest")[..., 0]
    if erosion_radius > 0:
        mask = erode(mask, erosion_radius)
    return mask
