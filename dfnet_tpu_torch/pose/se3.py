"""SE(3) pose helpers (port of dfnet_tpu/pose/se3.py: so far only the
world rescale that maps APR-frame poses into the NeRF's frame)."""

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
