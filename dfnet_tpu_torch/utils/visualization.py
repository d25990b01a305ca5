"""Visualization helpers: feature-saliency dumps, feature-map grids and
the predicted-against-GT pose plot (port of dfnet_tpu/utils/visualization.py;
reference script/utils/utils.py:41-123 and dm/pose_model.py:33-77).

Host-side numpy. matplotlib is not on the GPU machine, so nothing here
imports it: the jet colormap is computed from matplotlib's segment data,
viridis is carried as matplotlib's 8-bit table, `vis_pose` rasterises its
figure itself, and PNGs go through data/png.py::write_png.
"""

from __future__ import annotations

import math
from typing import Dict

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

# matplotlib's `viridis` (matplotlib/_cm_listed.py::_viridis_data) as the
# 256 x 3 uint8 table its colormap renders with bytes=True: (entry * 255)
# truncated, as hex
VIRIDIS_RGB8 = np.frombuffer(bytes.fromhex(
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163471265471466471567471669"
    "47186a48196b481a6c481c6e481d6f481e70482071482172482273482374472575472676472777472878472a79472b7a"
    "472c7b462d7c462f7c46307d46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c893c4d8a3c4e8a3b508a3b518a"
    "3a528b3a538b39548b39558b38568b38578c37588c37598c365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d"
    "32628d32638d31648d31658d31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e277d8e277e8e267f8e26808e"
    "26818e25828e25838d24848d24858d24868d23878d23888d23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c"
    "20908c20918c1f928c1f938b1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a98224aa8225ab8126ac8127ad80"
    "28ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a32b57a33b67935b77836b87738b97639b9763bba753dbb74"
    "3ebc7340bd7242be7144be7045bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d05279d1517cd24f7ed24e81d34c"
    "83d34b86d44988d5478bd5468dd64490d64392d74195d73f97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32"
    "addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51ef6e61ff8e621fae622fde724"), np.uint8).reshape(256, 3)


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


# ---------------------------------------------------------------- vis_pose
# The JAX package's figure (visualization.py:84-114): 8 x 6 in saved at dpi
# 50, a 3-D scatter at figure fractions AX3D_RECT viewed at elev 30, azim
# 120, and the angular-error strip at STRIP_RECT.
FIG_W, FIG_H = 400, 300
AX3D_RECT = (0.0, 0.2, 0.9, 0.75)
STRIP_RECT = (0.1, 0.05, 0.75, 0.12)
ELEV, AZIM = 30.0, 120.0
STRIP_ROWS = 20
PT = 50 / 72                              # px a point at dpi 50
DOT_RADIUS = (0.5 * math.sqrt(9.0) + 0.5 * 1.5) * PT   # marker s=9 pt^2, 1.5 pt edge
DOT_RGB = {"pose": (1.0, 0.0, 0.0), "pose_gt": (0.0, 0.5, 0.0)}   # 'r', 'g'
VIEW_2D = (-0.95 / 10, 0.9 / 10)          # Axes3D.set_top_view at _dist 10


def _nonsingular(v0: float, v1: float, expander: float, tiny: float = 1e-15):
    """matplotlib.transforms.nonsingular (increasing)."""
    if not (np.isfinite(v0) and np.isfinite(v1)):
        return -expander, expander
    if v1 < v0:
        v0, v1 = v1, v0
    v0, v1 = float(v0), float(v1)
    big = max(abs(v0), abs(v1))
    if big < (1e6 / tiny) * np.finfo(float).tiny:
        return -expander, expander
    if v1 - v0 <= big * tiny:
        if v0 == 0 and v1 == 0:
            return -expander, expander
        return v0 - expander * abs(v0), v1 + expander * abs(v1)
    return v0, v1


def axes3d_limits(points: np.ndarray) -> np.ndarray:
    """(3, 2) axis limits mplot3d's autoscale gives a scatter of (N, 3)
    points: the data range made non-singular, a 5% margin each side
    (axes.xmargin, ymargin; scatter raises zmargin to 0.05), then mplot3d's
    1/48 view margin."""
    lims = np.zeros((3, 2))
    for k in range(3):
        v0, v1 = _nonsingular(points[:, k].min(), points[:, k].max(), 0.05)
        d = (v1 - v0) * 0.05
        v0, v1 = _nonsingular(v0 - d, v1 + d, 0.001)
        d = (v1 - v0) * (1 / 48)
        lims[k] = v0 - d, v1 + d
    return lims


def axes3d_projection(lims: np.ndarray, elev: float = ELEV, azim: float = AZIM) -> np.ndarray:
    """The 4x4 matrix of Axes3D.get_proj: the box of `lims` scaled to the
    default 4:4:3 box aspect, viewed from distance 10 at (elev, azim) with
    the default perspective (focal length 1), z vertical, no roll."""
    aspect = np.array([4.0, 4.0, 3.0])
    aspect *= 1.8294640721620434 * 25 / 24 / np.linalg.norm(aspect)
    d = (lims[:, 1] - lims[:, 0]) / aspect
    world = np.array([[1 / d[0], 0, 0, -lims[0, 0] / d[0]],
                      [0, 1 / d[1], 0, -lims[1, 0] / d[1]],
                      [0, 0, 1 / d[2], -lims[2, 0] / d[2]],
                      [0, 0, 0, 1]])
    R = 0.5 * aspect
    e, a = np.deg2rad(elev), np.deg2rad(azim)
    ps = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)])
    eye = R + 10 * ps
    w = (eye - R) / np.linalg.norm(eye - R)
    u = np.cross(np.array([0.0, 0.0, 1.0]), w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    rot, shift = np.eye(4), np.eye(4)
    rot[:3, :3] = [u, v, w]
    shift[:3, -1] = -eye
    view = rot @ shift
    persp = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 0, -10.0], [0, 0, -1, 0]])
    return persp @ (view @ world)


def _project(xyz: np.ndarray, M: np.ndarray):
    """proj3d.proj_transform: (tx, ty, tz) of (N, 3) points."""
    vec = M @ np.concatenate([xyz.T, np.ones((1, len(xyz)))])
    return vec[0] / vec[3], vec[1] / vec[3], vec[2] / vec[3]


def _axes3d_box():
    """The 3-D axes' (x0, y0, w, h) in display pixels (origin bottom left):
    AX3D_RECT shrunk to a square on the figure and centred in it
    (Axes3D.apply_aspect)."""
    x0, y0, w, h = AX3D_RECT
    fig_aspect = FIG_H / FIG_W
    W, H = w, w / fig_aspect
    if H > h:
        W, H = h * fig_aspect, h
    x0, y0 = x0 + 0.5 * (w - W), y0 + 0.5 * (h - H)
    return x0 * FIG_W, y0 * FIG_H, W * FIG_W, H * FIG_H


def _to_display(tx, ty):
    """Projected (tx, ty) to display pixels through the 3-D axes' fixed
    2-D view (transData)."""
    bx, by, bw, bh = _axes3d_box()
    lo, hi = VIEW_2D
    return (bx + (np.asarray(tx) - lo) / (hi - lo) * bw,
            by + (np.asarray(ty) - lo) / (hi - lo) * bh)


def project_points(points, lims: np.ndarray) -> np.ndarray:
    """(N, 2) display positions (pixels at dpi 50, y up from the figure's
    bottom) of (N, 3) points in the 3-D axes of `lims`."""
    tx, ty, _ = _project(np.asarray(points, np.float64), axes3d_projection(lims))
    return np.stack(_to_display(tx, ty), -1)


def _coverage(inside, x0: int, x1: int, y0: int, y1: int, ss: int = 4) -> np.ndarray:
    """Share of each pixel of rows y0..y1-1, columns x0..x1-1 (array
    coordinates, pixel (r, c) covering [c, c+1) x [r, r+1)) that
    inside(x, y) covers, on an ss x ss grid of sub-samples."""
    off = (np.arange(ss) + 0.5) / ss
    xs = (np.arange(x0, x1)[:, None] + off).reshape(-1)
    ys = (np.arange(y0, y1)[:, None] + off).reshape(-1)
    hit = inside(xs[None, :], ys[:, None]).astype(np.float64)
    return hit.reshape(y1 - y0, ss, x1 - x0, ss).mean((1, 3))


def _blend(canvas: np.ndarray, cov: np.ndarray, rgb, alpha: float, x0: int, y0: int) -> None:
    """Paint rgb at coverage cov * alpha over canvas[y0:, x0:] (clipped)."""
    h, w = cov.shape
    ya, xa = max(y0, 0), max(x0, 0)
    yb, xb = min(y0 + h, canvas.shape[0]), min(x0 + w, canvas.shape[1])
    if ya >= yb or xa >= xb:
        return
    a = (cov[ya - y0:yb - y0, xa - x0:xb - x0] * alpha)[..., None]
    canvas[ya:yb, xa:xb] = canvas[ya:yb, xa:xb] * (1 - a) + np.asarray(rgb) * a


def _draw_dots(canvas: np.ndarray, sets, lims: np.ndarray, M: np.ndarray) -> None:
    """Each set's points as discs of DOT_RADIUS px, placed as Agg places
    markers (the projected position snapped to a pixel corner); sets drawn
    deepest first (mplot3d's collection order), each set's points far to
    near."""
    order = []
    for pts, rgb in sets:
        tx, ty, tz = _project(pts, M)
        order.append((np.min(tz), tx, ty, tz, rgb))
    r = DOT_RADIUS
    for _, tx, ty, tz, rgb in sorted(order, key=lambda o: -o[0]):
        dx, dy = _to_display(tx, ty)
        for i in np.argsort(tz)[::-1]:
            cx, cy = np.floor(dx[i] + 0.5), np.floor(FIG_H - dy[i] + 0.5)
            x0, y0 = int(cx - np.ceil(r)), int(cy - np.ceil(r))
            cov = _coverage(lambda x, y: (x - cx) ** 2 + (y - cy) ** 2 <= r * r,
                            x0, x0 + 2 * int(np.ceil(r)), y0, y0 + 2 * int(np.ceil(r)))
            _blend(canvas, cov, rgb, 1.0, x0, y0)


def _iround(v):
    return np.where(v < 0, np.trunc(v - 0.5), np.trunc(v + 0.5)).astype(np.int64)


def _hanning_lut() -> np.ndarray:
    """Agg's image_filter_lut for the hanning filter (radius 1, 8-bit
    sub-pixels, 14-bit weights), normalised as image_filter_lut::normalize
    does."""
    w = np.zeros(512, np.int64)
    i = np.arange(256)
    w[256 + i] = w[256 - i] = _iround((0.5 + 0.5 * np.cos(np.pi * i / 256.0)) * 16384)
    w[0] = w[511]
    flip = 1
    for i in range(256):
        while True:
            s = int(w[i] + w[256 + i])
            if s == 16384:
                break
            k = 16384.0 / s
            w[i], w[256 + i] = _iround(w[i] * k), _iround(w[256 + i] * k)
            s = int(w[i] + w[256 + i]) - 16384
            inc = -1 if s > 0 else 1
            for j in range(2):
                if not s:
                    break
                flip ^= 1
                idx = 1 + j // 2 if flip else 1 - j // 2
                if w[idx * 256 + i] < 16384:
                    w[idx * 256 + i] += inc
                    s += inc
    w[256 + np.arange(256)] = w[256 - np.arange(256)]
    w[0] = w[511]
    return w


def _dda(y1: int, y2: int, count: int) -> np.ndarray:
    """Agg's dda2_line_interpolator: count integer steps from y1 towards
    y2 (C division)."""
    cnt = max(count, 1)
    lft = int((y2 - y1) / cnt)
    rem = (y2 - y1) - lft * cnt
    mod = rem
    if mod <= 0:
        mod, rem, lft = mod + count, rem + count, lft - 1
    mod -= count
    out, y = [y1], y1
    for _ in range(count - 1):
        mod += rem
        y += lft
        if mod > 0:
            mod -= cnt
            y += 1
        out.append(y)
    return np.array(out, np.int64)


def _resample_hanning(src: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """(out_h, out_w, 4) int RGBA of the (h, w, 4) uint8 image `src`
    stretched over out_w x out_h pixels, as matplotlib's imshow resamples an
    image it upsamples by under 3 (Agg's span_image_filter_rgba with the
    hanning LUT, a linear span interpolator, edge pixels repeated beyond
    the image)."""
    h, w = src.shape[:2]
    lut = _hanning_lut()
    sx, sy = w / out_w, h / out_h
    X = _dda(int(_iround(0.5 * sx * 256)), int(_iround((out_w + 0.5) * sx * 256)), out_w) - 128
    xlr, xfr = X >> 8, X & 255
    src = src.astype(np.int64)
    out = np.zeros((out_h, out_w, 4), np.int64)
    for oy in range(out_h):
        Y = int(_iround((oy + 0.5) * sy * 256)) - 128
        ylr, yfr = Y >> 8, Y & 255
        acc = np.zeros((out_w, 4), np.int64)
        for dj in range(2):
            wy = lut[255 - yfr + 256 * dj]
            row = src[min(max(ylr + dj, 0), h - 1)]
            for di in range(2):
                wt = (wy * lut[255 - xfr + 256 * di] + 8192) >> 14
                acc += wt[:, None] * row[np.clip(xlr + di, 0, w - 1)]
        out[oy] = (acc + 8192) >> 14
    out = np.maximum(out, 0)
    out[..., 3] = np.minimum(out[..., 3], 255)
    out[..., :3] = np.minimum(out[..., :3], out[..., 3:])
    return out


def _mpl_scalar(v):
    """A norm limit as matplotlib's Normalize.process_value makes it: the
    smallest dtype that holds it, integers promoted to float32."""
    dt = np.min_scalar_type(v)
    if np.issubdtype(dt, np.integer) or dt.type is np.bool_:
        dt = np.promote_types(dt, np.float32)
    return np.asarray(v, dtype=dt)


def strip_box():
    """The strip's (x0, x1, y0, y1) in display pixels and its (width,
    height) in whole pixels (imshow rounds a fractional size up)."""
    x0, y0, w, h = STRIP_RECT
    bx0, bx1 = x0 * FIG_W, (x0 + w) * FIG_W
    by0, by1 = y0 * FIG_H, (y0 + h) * FIG_H
    return (bx0, bx1, by0, by1), (math.ceil(bx1 - bx0), math.ceil(by1 - by0))


def _strip_rgba(theta: np.ndarray, ang_threshold: float) -> np.ndarray:
    """(STRIP_ROWS, n, 4) uint8 of `theta` tiled STRIP_ROWS high, viridis
    over [0, ang_threshold] as Normalize + Colormap(bytes=True) map it
    (under: the first entry, over: the last, NaN: transparent)."""
    x = np.array(theta, copy=True)
    if x.dtype.kind != "f":
        x = x.astype(np.float32)
    x = (x - _mpl_scalar(0)) / (_mpl_scalar(ang_threshold) - _mpl_scalar(0))
    x = x * 256
    x[x == 256] = 255
    bad = np.isnan(x)
    idx = np.where(bad, 0, x)
    idx = np.where(idx < 0, 0, np.where(idx >= 256, 255, idx)).astype(int)
    rgba = np.concatenate([VIRIDIS_RGB8[idx], np.full((len(x), 1), 255, np.uint8)], 1)
    rgba[bad] = 0
    return np.repeat(rgba[None], STRIP_ROWS, 0)


def _draw_strip(canvas: np.ndarray, theta: np.ndarray, ang_threshold: float) -> None:
    (bx0, bx1, by0, by1), (out_w, out_h) = strip_box()
    img = _resample_hanning(_strip_rgba(theta, ang_threshold), out_w, out_h) / 255.0
    top, left = int(FIG_H - (by0 + out_h)), int(bx0)
    a = img[..., 3:]
    region = canvas[top:top + out_h, left:left + out_w]
    canvas[top:top + out_h, left:left + out_w] = img[..., :3] + region * (1 - a)
    # the frame: 0.8 pt black spines (0.56 px), snapped to pixel centres
    a = 0.8 * PT
    xa, xb = int(np.floor(bx0)), int(np.floor(bx1))
    ya, yb = int(np.floor(FIG_H - by1)), int(np.floor(FIG_H - by0))
    for sl in ((slice(ya, yb + 1), xa), (slice(ya, yb + 1), xb),
               (ya, slice(xa, xb + 1)), (yb, slice(xa, xb + 1))):
        canvas[sl] = canvas[sl] * (1 - a)


def vis_pose(vis_info: Dict, path: str = "./vis_pose.png",
             ang_threshold: float = 10.0) -> str:
    """3-D scatter of predicted (red) and GT (green) camera positions over
    a strip of per-frame angular errors (the JAX package's vis_pose, the
    reference's dm/pose_model.py:33-77), written as a 400 x 300 RGB PNG.

    vis_info: "pose" and "pose_gt" (N, 3) positions, "theta" (N,) errors
    in degrees, as numpy or torch. The figure is matplotlib's for the same
    calls (an 8 x 6 in figure saved at dpi 50) redrawn in numpy:
      - the 3-D axes at figure fractions AX3D_RECT (made square and
        centred, as mplot3d does), limits by mplot3d's autoscale, seen at
        elev 30, azim 120 in its default perspective; every position a
        disc of a size-9 marker (with its 1.5 pt edge), red over green
        where mplot3d's depth order puts it, placed as Agg places markers;
      - the strip at STRIP_RECT: theta tiled 20 rows high in viridis over
        [0, ang_threshold], resampled as imshow does an upsampled image
        (Agg's hanning filter: within one level of matplotlib's pixels),
        in its 0.8 pt black frame.
    Not drawn: the 3-D box's grey back panes, its grid, axis lines and
    ticks, the strip's ticks, and all text (tick labels, axis labels);
    depth shading is off in the JAX figure too. Returns `path`."""
    pose = _to_numpy(vis_info["pose"]).astype(np.float64)
    pose_gt = _to_numpy(vis_info["pose_gt"]).astype(np.float64)
    theta = _to_numpy(vis_info["theta"]).reshape(-1)
    lims = axes3d_limits(np.concatenate([pose, pose_gt]))
    M = axes3d_projection(lims)
    canvas = np.ones((FIG_H, FIG_W, 3))
    _draw_dots(canvas, [(pose, DOT_RGB["pose"]), (pose_gt, DOT_RGB["pose_gt"])], lims, M)
    _draw_strip(canvas, theta, ang_threshold)
    write_png(path, np.clip(np.round(canvas * 255), 0, 255).astype(np.uint8))
    return path
