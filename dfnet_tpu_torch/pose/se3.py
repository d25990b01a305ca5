"""SE(3) pose helpers (port of dfnet_tpu/pose/se3.py): the elementary
rotations, the Random View Synthesis perturbation, quaternion pose errors,
the SVD rotation projection, the world rescale that maps APR-frame
poses into the NeRF's frame, and the pose averaging, centering and
dataset coordinate fixes of the 7-Scenes and Cambridge readers.

Data-prep and metric functions are numpy, as in the JAX package, so both
packages draw the same perturbations from the same generator;
project_rotation_svd also has a torch form, differentiable, for train
steps."""

from __future__ import annotations

import numpy as np
import torch


def rescale_poses_to_nerf(poses, pose_scale: float, move_all_cam_vec,
                          pose_scale2: float):
    """Apply the per-scene world_setup rescale to the translation of
    (..., 3, 4) poses: t *= pose_scale; t += move; t *= pose_scale2.

    Takes numpy arrays (returns a new array) or torch tensors (returns a
    new tensor, differentiable in the poses: stage 3 rescales its
    predicted pose this way)."""
    if isinstance(poses, torch.Tensor):
        move = torch.as_tensor(move_all_cam_vec, dtype=poses.dtype, device=poses.device)
        out = poses.clone()
        out[..., :3, 3] = (poses[..., :3, 3] * pose_scale + move) * pose_scale2
        return out
    move = np.asarray(move_all_cam_vec, dtype=poses.dtype)
    out = poses.copy()
    out[..., :3, 3] = (poses[..., :3, 3] * pose_scale + move) * pose_scale2
    return out


# ---------------------------------------------------------------------------
# elementary rotations (4x4 homogeneous), angles in radians
# ---------------------------------------------------------------------------

def rot_phi(phi: float) -> np.ndarray:
    """Rotation about the x axis."""
    c, s = np.cos(phi), np.sin(phi)
    m = np.eye(4)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rot_theta(th: float) -> np.ndarray:
    """Rotation about the y axis (reference's convention: [[c,0,-s],[0,1,0],[s,0,c]])."""
    c, s = np.cos(th), np.sin(th)
    m = np.eye(4)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, -s, s, c
    return m


def rot_psi(psi: float) -> np.ndarray:
    """Rotation about the z axis."""
    c, s = np.cos(psi), np.sin(psi)
    m = np.eye(4)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


# ---------------------------------------------------------------------------
# pose averaging / centering (float64 numpy, as in the JAX package)
# ---------------------------------------------------------------------------

def average_poses(poses: np.ndarray) -> np.ndarray:
    """Average camera pose of a set of (N,3,4) c2w matrices.

    center = mean of centers; z = normalized mean z axis; x = y'×z
    normalized with y' the mean y axis; y = z×x.
    """
    center = poses[..., 3].mean(0)
    z = _normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = _normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)  # (3,4)


def center_poses(poses: np.ndarray, pose_avg: np.ndarray | None = None):
    """Transform all poses into the average pose's frame.

    Returns (poses_centered (N,3,4), pose_avg (3,4)).
    """
    if pose_avg is None:
        pose_avg = average_poses(poses)
    avg_homo = np.eye(4)
    avg_homo[:3] = pose_avg
    last = np.tile(np.array([0.0, 0.0, 0.0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last], 1)  # (N,4,4)
    centered = (np.linalg.inv(avg_homo) @ poses_homo)[:, :3]
    return centered, pose_avg


# ---------------------------------------------------------------------------
# dataset coordinate fixes
# ---------------------------------------------------------------------------

FLIP_YZ = np.diag([1.0, -1.0, -1.0, 1.0])  # mirror y & z


def fix_coord_7scenes(poses: np.ndarray, pose_avg: np.ndarray | None = None) -> np.ndarray:
    """Center (N,3,4) 7-Scenes poses and flip y/z to the LLFF convention.

    NOTE: the reference applies M@([R|T]@M), a one-sided association it
    flags as a bug (load_7Scenes.py:321-322), instead of the similarity
    M@[R|T]@M.T. Every released checkpoint was trained in that frame, so
    it is kept exactly.
    """
    centered, _ = center_poses(poses, pose_avg)
    last = np.tile(np.array([0.0, 0.0, 0.0, 1.0]), (len(centered), 1, 1))
    homo = np.concatenate([centered, last], 1)
    fixed = FLIP_YZ[None] @ (homo @ FLIP_YZ[None])
    return fixed[:, :3, :4]


def fix_coord_cambridge(poses: np.ndarray, pose_avg: np.ndarray | None = None) -> np.ndarray:
    """Center Cambridge poses, rotate 180° about x, negate the rotation
    block, then mirror the rotation about the x axis (R' = R @ diag(-1,1,1))."""
    centered, _ = center_poses(poses, pose_avg)
    last = np.tile(np.array([0.0, 0.0, 0.0, 1.0]), (len(centered), 1, 1))
    homo = np.concatenate([centered, last], 1)
    homo = rot_phi(np.pi)[None] @ homo
    homo[:, :3, :3] = -homo[:, :3, :3]
    homo[:, :3, :3] = homo[:, :3, :3] @ np.diag([-1.0, 1.0, 1.0])
    return homo[:, :3, :4]


# ---------------------------------------------------------------------------
# pose perturbation (Random View Synthesis)
# ---------------------------------------------------------------------------

def perturb_rotation(c2w: np.ndarray, theta: float, phi: float, psi: float = 0.0) -> np.ndarray:
    """Left-multiply a (3,4) pose by world-frame x/y/z rotations (degrees)."""
    homo = np.concatenate([c2w, np.array([[0.0, 0.0, 0.0, 1.0]])], 0)
    homo = rot_phi(phi / 180.0 * np.pi) @ homo
    homo = rot_theta(theta / 180.0 * np.pi) @ homo
    homo = rot_psi(psi / 180.0 * np.pi) @ homo
    return homo[:3, :4]


def perturb_single_render_pose(pose: np.ndarray, x: float, angle: float,
                               rng: np.random.Generator | None = None) -> np.ndarray:
    """RVS perturbation: random world-frame rotation of up to ±angle deg
    per axis, then ±x translation per axis; translation is preserved
    through the rotation step (rotation applies to orientation only here,
    matching misc.py:448-483)."""
    rng = rng or np.random.default_rng()
    new = pose.copy()
    loc = new[:, 3].copy()
    theta, phi, psi = rng.uniform(-angle, angle, 3)
    new = perturb_rotation(new, theta, phi, psi)
    new[:, 3] = loc + rng.uniform(-x, x, 3)
    return new


# ---------------------------------------------------------------------------
# quaternions & error metrics
# ---------------------------------------------------------------------------

def mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix (...,3,3) → unit quaternion (...,4) wxyz, w>=0 not enforced.

    Shepperd's method (numerically stable across all traces).
    """
    R = np.asarray(R, dtype=np.float64)
    batch = R.shape[:-2]
    R = R.reshape(-1, 3, 3)
    q = np.empty((R.shape[0], 4))
    for i, m in enumerate(R):
        t = np.trace(m)
        if t > 0:
            r = np.sqrt(1.0 + t)
            s = 0.5 / r
            q[i] = [0.5 * r, (m[2, 1] - m[1, 2]) * s,
                    (m[0, 2] - m[2, 0]) * s, (m[1, 0] - m[0, 1]) * s]
        else:
            k = np.argmax(np.diag(m))
            if k == 0:
                r = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2])
                s = 0.5 / r
                q[i] = [(m[2, 1] - m[1, 2]) * s, 0.5 * r,
                        (m[0, 1] + m[1, 0]) * s, (m[0, 2] + m[2, 0]) * s]
            elif k == 1:
                r = np.sqrt(1.0 - m[0, 0] + m[1, 1] - m[2, 2])
                s = 0.5 / r
                q[i] = [(m[0, 2] - m[2, 0]) * s, (m[0, 1] + m[1, 0]) * s,
                        0.5 * r, (m[1, 2] + m[2, 1]) * s]
            else:
                r = np.sqrt(1.0 - m[0, 0] - m[1, 1] + m[2, 2])
                s = 0.5 / r
                q[i] = [(m[1, 0] - m[0, 1]) * s, (m[0, 2] + m[2, 0]) * s,
                        (m[1, 2] + m[2, 1]) * s, 0.5 * r]
    return q.reshape(*batch, 4)


def pose_errors(pred: np.ndarray, gt: np.ndarray):
    """Per-sample translation (m) and rotation (deg) error.

    pred/gt: (N,3,4). Rotation error = 2·acos(|q_pred·q_gt|)·180/π, the
    canonical APR metric (dm/pose_model.py:136-141).
    """
    q1 = mat_to_quat(gt[:, :3, :3])
    q2 = mat_to_quat(pred[:, :3, :3])
    q1 = q1 / np.linalg.norm(q1, axis=-1, keepdims=True)
    q2 = q2 / np.linalg.norm(q2, axis=-1, keepdims=True)
    d = np.clip(np.abs(np.sum(q1 * q2, -1)), -1.0, 1.0)
    theta = 2.0 * np.degrees(np.arccos(d))
    t_err = np.linalg.norm(gt[:, :3, 3] - pred[:, :3, 3], axis=-1)
    return t_err, theta


def project_rotation_svd(pose: torch.Tensor) -> torch.Tensor:
    """Project the (..., 3, 3) rotation block of a (..., 3, 4) pose onto
    SO(3)-ish via SVD: R <- U V^T (no det correction, as the reference's
    torch.svd usage). Differentiable."""
    u, _, vt = torch.linalg.svd(pose[..., :3, :3], full_matrices=False)
    return torch.cat([u @ vt, pose[..., :3, 3:]], -1)


def project_rotation_svd_np(pose: np.ndarray) -> np.ndarray:
    out = np.array(pose, copy=True)
    u, _, vt = np.linalg.svd(out[..., :3, :3])
    out[..., :3, :3] = u @ vt
    return out
