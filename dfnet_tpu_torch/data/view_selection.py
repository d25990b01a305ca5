"""View-selection and camera-path utilities (port of
dfnet_tpu/data/view_selection.py, float64 numpy as there): spiral render
paths, random pose perturbation for view synthesis, frustum-overlap
unique-view selection for local NeRFs, and train/val overlap removal.

Reference: dataset_loaders/load_7Scenes.py — render_path_spiral (:199),
generate_render_pose (:210), perturb_render_pose (:238),
camera_frustum_initializer (:45), generate_sampling_frustum (:76),
compute_frustums_overlap (:101), fetch_unique_view_index (:346),
select_nearest_neighbor_views (:392), remove_overlap_data (:264).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from dfnet_tpu_torch.pose.se3 import perturb_rotation


def _normalize(v):
    return v / np.linalg.norm(v)


def viewmatrix(z, up, pos) -> np.ndarray:
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def render_path_spiral(c2w, up, rads, focal, zrate, rots, N) -> List[np.ndarray]:
    """Spiral of N c2w poses around a base pose (LLFF-style)."""
    rads = np.array(list(rads) + [1.0])
    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta),
                                     -np.sin(theta * zrate), 1.0]) * rads)
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        out.append(viewmatrix(z, up, c))
    return out


def generate_render_pose(poses: np.ndarray, bds: np.ndarray, n_views: int = 120,
                         n_rots: int = 2,
                         rng: np.random.Generator | None = None) -> List[np.ndarray]:
    """Pick a random anchor view and build an n_views spiral video path."""
    rng = rng or np.random.default_rng()
    c2w = poses[rng.integers(poses.shape[0])]
    up = _normalize(poses[:, :3, 1].sum(0))
    close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    rads = np.percentile(np.abs(poses[:, :3, 3]), 20, 0)
    return render_path_spiral(c2w, up, rads, focal, zrate=0.5, rots=n_rots, N=n_views)


def perturb_render_pose(poses: np.ndarray, x: float, angle: float, n_views: int = 10,
                        rng: np.random.Generator | None = None) -> Tuple[np.ndarray, int]:
    """n_views randomly rotated and translated copies of a random train pose."""
    rng = rng or np.random.default_rng()
    idx = int(rng.integers(poses.shape[0]))
    c2w = poses[idx]
    out = np.zeros((n_views, 3, 4))
    for i in range(n_views):
        p = c2w.copy()
        p[:, 3] = p[:, 3] + rng.uniform(-x, x, 3)
        theta, phi, psi = rng.uniform(-angle, angle, 3)
        out[i] = perturb_rotation(p, theta, phi, psi)
    return out, idx


# ---------------------------------------------------------------------------
# frustum overlap (local-NeRF view selection)
# ---------------------------------------------------------------------------

def init_K(f: float, cx: float, cy: float) -> np.ndarray:
    K = np.eye(3)
    K[0, 0] = K[1, 1] = f
    K[0, 2], K[1, 2] = cx, cy
    return K


def is_inside_frustum(p, x_res, y_res):
    return (0 < p[..., 0]) & (p[..., 0] < x_res) & (0 < p[..., 1]) & (p[..., 1] < y_res)


def generate_sampling_frustum(step, depth, K, f, cx, cy, x_res, y_res) -> np.ndarray:
    """Dense 3-D sample grid of the camera frustum out to `depth`."""
    x_max = depth * (x_res - cx) / f
    x_min = -depth * cx / f
    y_max = depth * (y_res - cy) / f
    y_min = -depth * cy / f
    Z, X, Y = np.meshgrid(np.arange(0, depth, step), np.arange(x_min, x_max, step),
                          np.arange(y_min, y_max, step), indexing="ij")
    P = np.stack([X, Y, Z], -1).reshape(-1, 3)
    p = P @ K.T
    ok = p[:, 2] >= 1e-5
    proj = p / np.where(ok, p[:, 2], 1.0)[:, None]
    return P[ok & is_inside_frustum(proj, x_res, y_res)]


def compute_frustums_overlap(pose0, pose1, sampling_frustum, K, x_res, y_res) -> float:
    """Fraction of pose0's frustum samples visible from pose1."""
    R0, t0 = pose0[:3, :3], pose0[:3, 3]
    R1, t1 = pose1[:3, :3], pose1[:3, 3]
    R10 = R1.T @ R0
    t10 = R1.T @ (t0 - t1)
    p = (sampling_frustum @ R10.T + t10) @ K.T
    res = is_inside_frustum(p / p[:, 2:3], x_res, y_res)
    return float(res.sum()) / float(res.shape[0])


def camera_frustum_initializer(near_far, sample_step: float = 0.1, f: float = 585.0 / 2,
                               x_res: float = 320.0, y_res: float = 240.0):
    K = init_K(f, x_res / 2, y_res / 2)
    frustum = generate_sampling_frustum(sample_step, near_far[1], K, f, x_res / 2,
                                        y_res / 2, x_res, y_res)
    return K, frustum, x_res, y_res


def fetch_unique_view_index(poses: np.ndarray, threshold: float, near_far,
                            verbose: bool = False) -> np.ndarray:
    """Greedy unique-view (keyframe) selection by frustum overlap."""
    K, frustum, W, H = camera_frustum_initializer(near_far)

    def overlap(j, i):
        return compute_frustums_overlap(poses[j].reshape(3, 4), poses[i].reshape(3, 4),
                                        frustum, K, W, H)

    keyframe, unique = 0, [0]
    for i in range(len(poses)):
        if keyframe == i or overlap(keyframe, i) > threshold:
            continue
        if any(overlap(j, i) > threshold for j in unique):
            keyframe = i
            continue
        unique.append(i)
        keyframe = i
        if verbose:
            print(unique)
    return np.array(unique)


def select_nearest_neighbor_views(poses: np.ndarray, threshold: float, unique_frame_index,
                                  near_far, stride: int = 5) -> np.ndarray:
    """Indices of views overlapping any unique view (subsampled by stride)."""
    K, frustum, W, H = camera_frustum_initializer(near_far)
    out = [i for i in range(len(poses))
           if any(compute_frustums_overlap(poses[j].reshape(3, 4), poses[i].reshape(3, 4),
                                           frustum, K, W, H) > threshold
                  for j in unique_frame_index)]
    return np.array(out)[::stride]


def remove_overlap_data(train_split, val_split):
    """Drop val items whose gt_idx already appears in train
    (load_7Scenes.py:264-277)."""
    mask = ~np.isin(val_split.gt_idx, train_split.gt_idx)
    val_split.gt_idx = val_split.gt_idx[mask]
    val_split.poses = val_split.poses[mask]
    val_split.images = val_split.images[mask]
    val_split.hists = val_split.hists[mask]
    return train_split, val_split
