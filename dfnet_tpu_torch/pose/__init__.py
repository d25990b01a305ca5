"""Pose geometry (port of dfnet_tpu/pose)."""

from dfnet_tpu_torch.pose.se3 import (
    average_poses,
    center_poses,
    fix_coord_7scenes,
    fix_coord_cambridge,
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

__all__ = ["average_poses", "center_poses", "fix_coord_7scenes", "fix_coord_cambridge",
           "mat_to_quat", "perturb_rotation", "perturb_single_render_pose",
           "pose_errors", "project_rotation_svd", "project_rotation_svd_np",
           "rescale_poses_to_nerf", "rot_phi", "rot_psi", "rot_theta"]
