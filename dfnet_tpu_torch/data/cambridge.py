"""Cambridge Landmarks dataset reader (pre-extracted layout) -> dense
arrays (port of dfnet_tpu/data/cambridge.py).

Layout contract (reference: dataset_loaders/cambridge_scenes.py):
  <root>/deepslam_data/Cambridge/<scene>/{train,test}/{rgb/, poses/}
  <root>/Cambridge/<scene>/{world_setup.json,pose_avg_stats.txt}
Per-frame 4x4 pose text files; frames 480x854 with focal 744. Two corrupt
ShopFacade train frames (indices 42 and 35 of the sorted list) are
dropped, matching cambridge_scenes.py:169-173. Frames are decoded by
data/png.py.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import List

import numpy as np

from dfnet_tpu_torch.data.color import downscale_area, luminance_histogram
from dfnet_tpu_torch.data.png import read_image
from dfnet_tpu_torch.data.scene import Split


def load_cambridge_split(
    data_path: str,
    scene: str,
    train: bool,
    skip: int = 1,
    df: float = 2.0,
    hist_bin: int = 10,
    ret_hist: bool = True,
    ret_idx: bool = False,
    fix_idx: bool = False,
) -> Split:
    root = osp.join(data_path, scene, "train" if train else "test")
    rgb_dir = osp.join(root, "rgb")
    pose_dir = osp.join(root, "poses")

    rgb_files = sorted(osp.join(rgb_dir, f) for f in os.listdir(rgb_dir))
    pose_files = sorted(osp.join(pose_dir, f) for f in os.listdir(pose_dir))

    if scene == "ShopFacade" and train:
        for bad in (42, 35):
            del rgb_files[bad]
            del pose_files[bad]
    if len(rgb_files) != len(pose_files):
        raise ValueError("RGB file count does not match pose file count")

    frame_idx = np.arange(len(rgb_files))
    if skip > 1:
        frame_idx = frame_idx[::skip]

    poses: List[np.ndarray] = []
    images, hists = [], []
    for j, i in enumerate(frame_idx):
        pose = np.loadtxt(pose_files[i])
        poses.append(pose[:3, :4])
        img = downscale_area(read_image(rgb_files[i]), df)
        images.append(img)
        if ret_hist:
            hists.append(luminance_histogram(img, hist_bin))
        elif ret_idx:
            # per-image-index embedding label (encode_hist=False): split
            # position while training, 0 otherwise (reference seven_scenes.py:340-344)
            hists.append(np.full(1, j if (train and not fix_idx) else 0, np.int32))
        else:
            hists.append(np.zeros(1, np.int32))

    return Split(
        images=np.stack(images).astype(np.float32),
        poses=np.asarray(poses, dtype=np.float32),
        hists=np.stack(hists).astype(np.int32),
        gt_idx=frame_idx.astype(np.int64),
    )
