"""Inputs the benchmark makes from a seed: the analytic scene, its camera
poses and ground-truth frames, their luminance histograms, and the NeRF-H
parameter tree of a seeded init.

The scene and pose generators are frozen copies of
dfnet_tpu_torch/data/synthetic.py (`make_blob_field`, `look_at_pose`,
`sphere_poses`, `render_gt_image`) and data/color.py
(`luminance_histogram`): a handful of Gaussian density blobs, ray-marched
densely in float64, seen from cameras on a sphere of radius 2 looking at
the origin. The frames render in batches on the device; the init follows
the port's law (torch.nn.Linear's uniform bound, N(0, 1) embeddings) in
two large draws on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

NEAR, FAR = 0.5, 3.5
RADIUS = 2.0
PHI_RANGE = (math.pi / 4, math.pi / 2.2)     # the upper hemisphere band
_YUV_Y = np.array([0.299, 0.587, 0.114], np.float32)


@dataclass
class BlobField:
    centers: np.ndarray   # (K, 3)
    sigmas: np.ndarray    # (K,)
    amps: np.ndarray      # (K,)
    colors: np.ndarray    # (K, 3)


def make_blob_field(seed: int, K: int = 6) -> BlobField:
    rng = np.random.default_rng(seed)
    return BlobField(centers=rng.uniform(-0.6, 0.6, (K, 3)),
                     sigmas=rng.uniform(0.12, 0.3, K),
                     amps=rng.uniform(8.0, 20.0, K),
                     colors=rng.uniform(0.1, 1.0, (K, 3)))


def look_at_pose(campos: np.ndarray, target=np.zeros(3),
                 up=np.array([0.0, 1.0, 0.0])) -> np.ndarray:
    """c2w (3, 4) of a camera at campos looking along -z at target."""
    z = campos - target
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z, campos], 1)


def sphere_poses(n: int, rng: np.random.Generator, radius: float = RADIUS) -> np.ndarray:
    """(n, 3, 4) float32 cameras on the sphere's upper band."""
    poses = []
    for _ in range(n):
        theta = rng.uniform(0, 2 * np.pi)
        phi = rng.uniform(*PHI_RANGE)
        pos = radius * np.array([np.sin(phi) * np.cos(theta), np.cos(phi),
                                 np.sin(phi) * np.sin(theta)])
        poses.append(look_at_pose(pos))
    return np.stack(poses).astype(np.float32)


def pixel_rays(H: int, W: int, focal: float, c2w: torch.Tensor):
    """(rays_o, rays_d), each (H*W, 3) float32, of the pinhole camera c2w
    (3, 4): pixel (i, j) looks along [(i - W/2)/f, -(j - H/2)/f, -1]."""
    c2w = c2w.float()
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=c2w.device),
                          torch.arange(W, dtype=torch.float32, device=c2w.device),
                          indexing="ij")
    dirs = torch.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal,
                        -torch.ones_like(i)], -1).reshape(-1, 3)
    rays_d = dirs @ c2w[:3, :3].T
    return c2w[:3, 3].expand(rays_d.shape), rays_d


def render_frames(field: BlobField, poses: np.ndarray, H: int, W: int, focal: float,
                  brightness: np.ndarray, device, n_samples: int = 192,
                  block: int = 1 << 15) -> np.ndarray:
    """(B, H, W, 3) float32 frames of the field at `poses` (B, 3, 4): dense
    quadrature with float32 sample positions and the field in float64,
    each frame scaled by its brightness and clipped to [0, 1]."""
    dev = torch.device(device)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    centers, sigmas, amps, colors = (f64(field.centers), f64(field.sigmas),
                                     f64(field.amps), f64(field.colors))
    t = torch.as_tensor(np.linspace(NEAR, FAR, n_samples, dtype=np.float32), device=dev)
    delta = (FAR - NEAR) / (n_samples - 1)
    pt = torch.as_tensor(poses, device=dev)
    rays = [pixel_rays(H, W, focal, p) for p in pt]
    ro = torch.cat([o for o, _ in rays])
    rd = torch.cat([d for _, d in rays])
    out = []
    for o, d in zip(ro.split(block), rd.split(block)):
        pts = o[:, None, :] + d[:, None, :] * t[:, None]
        d2 = torch.sum((pts[..., None, :].double() - centers) ** 2, -1)
        g = amps * torch.exp(-0.5 * d2 / sigmas ** 2)
        rgb = torch.clamp((g[..., None] * colors).sum(-2) / (g.sum(-1, keepdim=True) + 1e-8),
                          0.0, 1.0)
        alpha = 1.0 - torch.exp(-g.sum(-1) * delta)
        trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
        trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
        out.append(((alpha * trans)[..., None] * rgb).sum(-2))
    img = torch.cat(out).reshape(len(poses), H, W, 3)
    b = torch.as_tensor(np.asarray(brightness, np.float64), device=dev)[:, None, None, None]
    return torch.clamp(img * b, 0.0, 1.0).float().cpu().numpy()


def luminance_histogram(img_hwc: np.ndarray, bins: int = 10) -> np.ndarray:
    """Rounded percentage histogram of the Y channel, int32 (bins,) in
    [0, 100]: the NeRF-H appearance and transient table indices."""
    y = img_hwc @ _YUV_Y
    hist, _ = np.histogram(y, bins=bins, range=(0.0, 1.0))
    hist = hist.astype(np.float64)
    if hist.sum() > 0:
        hist = hist / hist.sum() * 100.0
    return np.round(hist).astype(np.int32)


def frames_and_hists(field: BlobField, poses: np.ndarray, H: int, W: int, focal: float,
                     brightness: np.ndarray, device, hist_bin: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    imgs = render_frames(field, poses, H, W, focal, brightness, device)
    return imgs, np.stack([luminance_histogram(im, hist_bin) for im in imgs])


# ----------------------------------------------------------- the NeRF-H tree

def nerfh_layers(c: Dict) -> List[Tuple[str, int, int]]:
    """[(path, fan_in, fan_out)] of every linear layer of the NeRF-H bundle
    that the configuration `c` (a benchmark/configs file) describes: the
    coarse NeRF-W net (static heads), the NeRF-W fine net (appearance and
    transient heads) and the sigma-only proposal net."""
    in_xyz, in_dir = 3 + 6 * c["multires"], 3 + 6 * c["multires_views"]
    in_p = 3 + 6 * c["proposal_multires"]

    def trunk(net, D, W, inp, skips):
        return [(f"{net}/xyz_{i}", inp if i == 0 else (W + inp if i in skips else W), W)
                for i in range(D)]

    out = []
    for net, D, W, fine in (("coarse", c["netdepth"], c["netwidth"], False),
                            ("fine", c["netdepth_fine"], c["netwidth_fine"], True)):
        h = W // 2
        out += trunk(net, D, W, in_xyz, c["skips"])
        out += [(f"{net}/xyz_final", W, W),
                (f"{net}/dir", W + in_dir + (c["in_channels_a"] if fine else 0), h),
                (f"{net}/static_sigma", W, 1), (f"{net}/static_rgb", h, 3)]
        if fine:
            out += [(f"{net}/trans_0", W + c["in_channels_t"], h)]
            out += [(f"{net}/trans_{i}", h, h) for i in (1, 2, 3)]
            out += [(f"{net}/trans_sigma", h, 1), (f"{net}/trans_rgb", h, 3),
                    (f"{net}/trans_beta", h, 1)]
    out += trunk("proposal", c["proposal_D"], c["proposal_W"], in_p, ())
    out += [("proposal/static_sigma", c["proposal_W"], 1)]
    return out


def _put(tree: Dict, path: str, value) -> None:
    *parents, leaf = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def tree_of(items) -> Dict:
    """The nested dict of (path, leaf) pairs, paths joined by '/'."""
    tree: Dict = {}
    for path, value in items:
        _put(tree, path, value)
    return tree


def init_nerfh(c: Dict, gen: torch.Generator, device) -> Dict:
    """A seeded NeRF-H params tree on `device` at the port's init law:
    weights and biases uniform in +-1/sqrt(fan_in), the embedding tables
    N(0, 1); two draws in all."""
    layers = nerfh_layers(c)
    total = sum(fi * fo + fo for _, fi, fo in layers)
    u = torch.rand(total, generator=gen, device=device) * 2 - 1
    tree: Dict = {}
    off = 0
    for path, fi, fo in layers:
        bound = 1.0 / math.sqrt(fi)
        _put(tree, path + "/w", u[off:off + fi * fo].view(fi, fo) * bound)
        off += fi * fo
        _put(tree, path + "/b", u[off:off + fo] * bound)
        off += fo
    hb, nv = c["hist_bin"], c["N_vocab"]
    n_a, n_t = c["in_channels_a"] // hb, c["in_channels_t"] // hb
    e = torch.randn(nv * (n_a + n_t), generator=gen, device=device)
    tree["embedding_a"] = e[:nv * n_a].view(nv, n_a)
    tree["embedding_t"] = e[nv * n_a:].view(nv, n_t)
    return tree


def load_npz_tree(path: str) -> Dict:
    """The params tree of a checkpoint in the packages' flat npz layout
    (`tree/<path>` keys; `tree/params/<path>` when it holds an optimizer
    state too), as numpy arrays."""
    tree: Dict = {}
    with np.load(path, allow_pickle=False) as data:
        for k in data.files:
            if not k.startswith("tree/"):
                continue
            p = k[len("tree/"):]
            if p.startswith("params/"):
                p = p[len("params/"):]
            elif p.startswith("opt_state/"):
                continue
            _put(tree, p, np.asarray(data[k], np.float32))
    return tree


def leaves(tree: Dict, prefix: str = "") -> List[Tuple[str, object]]:
    """(path, leaf) of a nested dict, in sorted key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]
    return out


def tree_map(fn, tree: Dict) -> Dict:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}
