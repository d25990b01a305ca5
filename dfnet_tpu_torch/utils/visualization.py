"""Visualization helpers: feature-saliency dumps and feature-map grids
(port of dfnet_tpu/utils/visualization.py:23-81; reference
script/utils/utils.py:41-123).

Host-side numpy. The jet colormap is matplotlib's, computed here from its
segment data (matplotlib is not on the GPU machine), and PNGs go through
data/png.py::write_png. JAX's `vis_pose` (a matplotlib 3-D plot with no
caller in either package) is not here.
"""

from __future__ import annotations

import numpy as np

from dfnet_tpu_torch.data.png import write_png

# matplotlib's `jet` (matplotlib/_cm.py::_jet_data): per channel, the
# (x, y0, y1) breakpoints of a piecewise-linear map of [0, 1]
JET_SEGMENTS = {
    "red": ((0.00, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.00, 0.5, 0.5)),
    "green": ((0.000, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.640, 1, 1), (0.910, 0, 0),
              (1.000, 0, 0)),
    "blue": ((0.00, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.00, 0, 0)),
}
JET_N = 256


def _segment_lut(data, n: int = JET_N) -> np.ndarray:
    """The n-entry table of one channel, as matplotlib's
    colors._create_lookup_table builds it (gamma 1)."""
    a = np.array(data, dtype=float)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


JET_LUT = np.stack([_segment_lut(JET_SEGMENTS[c]) for c in ("red", "green", "blue")], -1)


def _to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _jet(img01: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB of matplotlib's `cm.jet(clip(img01, 0, 1))[..., :3]
    * 255`: values scaled by 256 in their own float type, 1.0 mapped to the
    last entry, truncated to an index into the 256-entry table; NaN maps
    to black (jet's 'bad' colour, alpha 0)."""
    xa = np.array(np.clip(img01, 0, 1), copy=True)
    if xa.dtype.kind != "f":
        xa = xa.astype(float)
    xa *= JET_N
    xa[xa == JET_N] = JET_N - 1
    bad = np.isnan(xa)
    idx = np.where(bad, 0, xa).astype(int)
    rgb = JET_LUT[np.clip(idx, 0, JET_N - 1)]
    rgb[bad] = 0.0
    return (rgb * 255).astype(np.uint8)


def _make_grid(tensor, nrow: int = 8, padding: int = 2,
               normalize: bool = False) -> np.ndarray:
    """(B, H, W) or (B, H, W, 1) single-channel maps -> one (H', W') grid."""
    t = _to_numpy(tensor)
    if t.ndim == 4:
        t = t[..., 0]
    if normalize:
        lo, hi = t.min(), t.max()
        t = (t - lo) / max(hi - lo, 1e-12)
    b, h, w = t.shape
    ncol = min(nrow, b)
    nrows = int(np.ceil(b / ncol))
    grid = np.zeros((nrows * (h + padding) + padding, ncol * (w + padding) + padding),
                    t.dtype)
    for i in range(b):
        r, c = divmod(i, ncol)
        y0 = r * (h + padding) + padding
        x0 = c * (w + padding) + padding
        grid[y0:y0 + h, x0:x0 + w] = t[i]
    return grid


def _png_path(path: str) -> str:
    return path if path.endswith(".png") else path + ".png"


def save_image_saliancy(features, path: str, normalize: bool = False):
    """Sum feature channels into a saliency map per sample, jet-colormap,
    save a grid PNG. features: (B, H, W, C) with C > 4, (B, C, H, W), or
    (B, H, W) maps."""
    f = _to_numpy(features)
    if f.ndim == 4 and f.shape[-1] > 4:      # NHWC
        sal = f.sum(-1)
    elif f.ndim == 4:                        # NCHW
        sal = f.sum(1)
    else:
        sal = f
    write_png(_png_path(path), _jet(_make_grid(sal, normalize=True)))


def save_image_saliancy_single(feature, path: str, normalize: bool = False):
    """One sample: an (H, W, C) feature stack, or one (H, W) map. The JAX
    package passes an (H, W) map through unbatched and fails in
    _make_grid; here it is the grid of that one map."""
    f = _to_numpy(feature)
    save_image_saliancy(f[None] if f.ndim in (2, 3) else f, path, normalize)


def plot_features(features, path: str, normalize: bool = False,
                  max_channels: int = 64):
    """Dump per-channel feature maps of one sample as a grid PNG.
    features: (H, W, C)."""
    chans = np.moveaxis(_to_numpy(features), -1, 0)[:max_channels]   # (C, H, W)
    write_png(_png_path(path), _jet(_make_grid(chans, normalize=True)))
