"""Pose geometry (port of dfnet_tpu/pose): so far only the world rescale."""

from dfnet_tpu_torch.pose.se3 import rescale_poses_to_nerf

__all__ = ["rescale_poses_to_nerf"]
