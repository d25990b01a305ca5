"""Color-space and luminance-histogram utilities.

The histogram label is the key input of the "Histogram-assisted" NeRF:
each image's Y-channel intensity histogram (10 bins over [0,1], as
rounded percentages) indexes the appearance/transient embedding tables
(DFNet reference: dataset_loaders/seven_scenes.py:346-352,
dataset_loaders/utils/color.py). Port copy of dfnet_tpu/data/color.py.
"""

from __future__ import annotations

import math

import numpy as np

# BT.601-ish YUV matrix (matches the kornia rgb_to_yuv used by the reference)
_YUV = np.array(
    [[0.299, 0.587, 0.114],
     [-0.147, -0.289, 0.436],
     [0.615, -0.515, -0.100]], dtype=np.float32)


def rgb_to_yuv(img: np.ndarray) -> np.ndarray:
    """RGB (..., 3) in [0,1] → YUV (..., 3). Channel-last."""
    return img @ _YUV.T


def luminance_histogram(img_hwc: np.ndarray, bins: int = 10) -> np.ndarray:
    """Rounded percentage histogram of the Y channel.

    Equivalent to torch.histc(y, bins, 0, 1) → /sum*100 → round
    (round-half-to-even, same as torch). Returns int32 (bins,), each in
    [0, 100] — used as indices into the N_vocab embedding tables.
    """
    y = rgb_to_yuv(img_hwc)[..., 0]
    hist, _ = np.histogram(y, bins=bins, range=(0.0, 1.0))
    hist = hist.astype(np.float64)
    total = hist.sum()
    if total > 0:
        hist = hist / total * 100.0
    return np.round(hist).astype(np.int32)


def _area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) float64 weights of cv2.INTER_AREA along one axis: row d
    holds the overlap of output pixel d, the source interval
    [d*scale, (d+1)*scale), with each input pixel, over the cell width.
    The table of OpenCV's computeResizeAreaTab, kept exactly: scale is
    1 / (dst / src), slivers under 1e-3 of a pixel are dropped, the last
    cell is clipped to the image, and each weight is rounded to float32."""
    scale = 1.0 / (dst / src)
    a = np.zeros((dst, src))
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            a[d, s1 - 1] = np.float32((s1 - f1) / cell)
        a[d, s1:s2] = np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            a[d, s2] = np.float32(min(f2 - s2, 1.0, cell) / cell)
    return a


def _block_mean(img: np.ndarray, ky: int, kx: int) -> np.ndarray:
    """The mean of each ky x kx block in float32, in the order of OpenCV's
    scalar area-fast path (resizeAreaFast_): the block's samples row-major,
    summed in groups of four, each group left to right, then the leftover
    samples one by one, times float32(1 / area). For 3-channel images cv2
    takes this path at every factor, so the result is its bits."""
    h, w = img.shape[0] // ky, img.shape[1] // kx
    x = np.asarray(img, np.float32).reshape(h, ky, w, kx, -1)
    x = x.transpose(0, 2, 1, 3, 4).reshape(h, w, ky * kx, -1)
    s = np.zeros((h, w, x.shape[-1]), np.float32)
    k = 0
    while k + 4 <= ky * kx:
        s += ((x[:, :, k] + x[:, :, k + 1]) + x[:, :, k + 2]) + x[:, :, k + 3]
        k += 4
    for k in range(k, ky * kx):
        s += x[:, :, k]
    return (s * np.float32(1.0 / (ky * kx))).reshape(h, w, *img.shape[2:])


def downscale_area(img: np.ndarray, df: float) -> np.ndarray:
    """cv2.INTER_AREA downscale by any factor df >= 1 to
    (int(H // df), int(W // df)), as the JAX package computes it with cv2
    (the reference's dataset resize, seven_scenes.py:328-332), in numpy.
    Where both sides divide exactly (cv2's area-fast case) it is the block
    mean in cv2's float32 order (_block_mean); otherwise A_y @ img @ A_x.T
    over the area-weight matrices of _area_weights in float64, cast to
    float32, within 1e-6 of cv2's float32 sums."""
    if df == 1.0:
        return img
    h, w = img.shape[:2]
    dh, dw = int(h // df), int(w // df)
    ky, kx = 1.0 / (dh / h), 1.0 / (dw / w)
    if ky == int(ky) and kx == int(kx):
        return _block_mean(img, int(ky), int(kx))
    rows = np.tensordot(_area_weights(h, dh), np.asarray(img, np.float64), axes=(1, 0))
    out = np.tensordot(_area_weights(w, dw), rows, axes=(1, 1))     # (w', h', ...)
    return np.moveaxis(out, 0, 1).astype(np.float32)
