"""Scene container shared by all datasets and pipeline stages.

Unlike the reference's torch DataLoader pipeline (per-item PIL decode in
worker processes, reference: dataset_loaders/load_7Scenes.py:488-491),
datasets here are loaded eagerly into dense numpy arrays with fixed
shapes: whole splits can be moved to the device once and sliced
there, and every train step sees static shapes.
"""

from __future__ import annotations

import json
import os.path as osp
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Split:
    images: np.ndarray          # (N, H, W, 3) float32 in [0,1]
    poses: np.ndarray           # (N, 3, 4) float32 — dataset-fixed frame
    hists: np.ndarray           # (N, hist_bin) int32 — histogram labels (or (N,1) indices)
    gt_idx: np.ndarray          # (N,) original frame indices

    def __len__(self) -> int:
        return self.images.shape[0]


@dataclass
class SceneData:
    train: Split
    val: Split
    hwf: List                   # [H, W, focal]
    near: float
    far: float
    world_setup: Dict           # pose_scale / pose_scale2 / move_all_cam_vec
    name: str = "scene"

    @property
    def H(self) -> int:
        return int(self.hwf[0])

    @property
    def W(self) -> int:
        return int(self.hwf[1])

    @property
    def focal(self) -> float:
        return float(self.hwf[2])


def load_world_setup(scene_meta_dir: str) -> Dict:
    """Read per-scene world_setup.json (near/far/pose_scale/pose_scale2/
    move_all_cam_vec; reference: seven_scenes.py:224-236)."""
    with open(osp.join(scene_meta_dir, "world_setup.json")) as fh:
        obj = json.load(fh)
    return {
        "near": float(obj["near"]),
        "far": float(obj["far"]),
        "pose_scale": float(obj["pose_scale"]),
        "pose_scale2": float(obj["pose_scale2"]),
        "move_all_cam_vec": [float(x) for x in obj["move_all_cam_vec"]],
    }


def load_pose_avg_stats(scene_meta_dir: str) -> Optional[np.ndarray]:
    """The (3, 4) pose average of <dir>/pose_avg_stats.txt, or None when
    the file is absent."""
    path = osp.join(scene_meta_dir, "pose_avg_stats.txt")
    if osp.exists(path):
        return np.loadtxt(path).reshape(3, 4)
    return None
