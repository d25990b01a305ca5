"""Pose geometry (port of dfnet_tpu/pose, the parts stage 2 uses)."""

from dfnet_tpu_torch.pose.se3 import (
    mat_to_quat,
    perturb_rotation,
    perturb_single_render_pose,
    pose_errors,
    project_rotation_svd,
    project_rotation_svd_np,
    rescale_poses_to_nerf,
    rot_phi,
    rot_psi,
    rot_theta,
)

__all__ = ["mat_to_quat", "perturb_rotation", "perturb_single_render_pose",
           "pose_errors", "project_rotation_svd", "project_rotation_svd_np",
           "rescale_poses_to_nerf", "rot_phi", "rot_psi", "rot_theta"]
