"""Pose-error evaluation: the canonical APR metric (port of
dfnet_tpu/training/eval_pose.py).

Per-image pose regression, SVD-orthonormalized rotation, quaternion angular
error 2·acos(|q·q̂|)·180/π plus translation L2, median and mean reported.
The split is forwarded in fixed-size device batches (the last one padded
with its last image) and read back once; the quaternion math runs in numpy.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from dfnet_tpu_torch.data.scene import Split
from dfnet_tpu_torch.pose import pose_errors, project_rotation_svd_np


def predict_poses(apply_fn: Callable, images: np.ndarray, batch: int = 8) -> np.ndarray:
    """apply_fn: (B, H, W, 3) numpy images -> (B, 12) tensor on the device.
    Returns (N, 3, 4) numpy (no SVD)."""
    n = images.shape[0]
    preds = []
    for i in range(0, n, batch):
        chunk = images[i:i + batch]
        pad = batch - chunk.shape[0]
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)], 0)
        preds.append(apply_fn(chunk)[: batch - pad])
    return torch.cat(preds, 0).cpu().numpy().reshape(n, 3, 4)


def get_error_in_q(apply_fn: Callable, split: Split, batch: int = 8,
                   use_svd: bool = True, verbose: bool = True
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (median, mean) of per-image [trans_m, rot_deg] errors."""
    pred = predict_poses(apply_fn, split.images, batch)
    if use_svd:
        pred = project_rotation_svd_np(pred)
    t_err, r_err = pose_errors(pred, split.poses.reshape(-1, 3, 4))
    results = np.stack([t_err, r_err], -1)
    median = np.median(results, axis=0)
    mean = np.mean(results, axis=0)
    if verbose:
        print(f"Median error {median[0]}m and {median[1]} degrees.")
        print(f"Mean error {mean[0]}m and {mean[1]} degrees.")
    return median, mean
