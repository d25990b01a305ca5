"""7-Scenes dataset reader (MSR layout) -> dense numpy arrays (port of
dfnet_tpu/data/seven_scenes.py).

Layout contract (reference: dataset_loaders/seven_scenes.py):
  <root>/deepslam_data/7Scenes/<scene>/seq-XX/frame-%06d.{color.png,pose.txt}
  <root>/deepslam_data/7Scenes/<scene>/{TrainSplit,TestSplit}.txt
  <root>/7Scenes/<scene>/{world_setup.json,pose_avg_stats.txt}
Split files list "sequenceN" lines. trainskip/testskip subsample each
sequence; df area-downscales (data/color.py::downscale_area); the
luminance histogram label is computed on the downscaled image. Frames are
decoded by data/png.py.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import List

import numpy as np

from dfnet_tpu_torch.data.color import downscale_area, luminance_histogram
from dfnet_tpu_torch.data.png import read_image
from dfnet_tpu_torch.data.scene import Split


def _read_split_seqs(base_dir: str, train: bool) -> List[int]:
    fname = "TrainSplit.txt" if train else "TestSplit.txt"
    with open(osp.join(base_dir, fname)) as fh:
        return [int(l.split("sequence")[-1]) for l in fh if not l.startswith("#")]


def load_seven_scenes_split(
    data_path: str,
    scene: str,
    train: bool,
    skip: int = 1,
    df: float = 1.0,
    hist_bin: int = 10,
    ret_hist: bool = True,
    ret_idx: bool = False,
    fix_idx: bool = False,
) -> Split:
    """Load one split as dense arrays. `skip` plays trainskip/testskip.

    gt_idx is each frame's index plus the frame count of the split's
    earlier sequences. ret_idx (NeRF-W per-image-index embedding mode,
    encode_hist=False): the label is the frame's position in the split, 0
    for test splits or when fix_idx is set (reference: seven_scenes.py:340-344)."""
    base_dir = osp.join(osp.expanduser(data_path), scene)
    seqs = _read_split_seqs(base_dir, train)

    c_imgs: List[str] = []
    poses: List[np.ndarray] = []
    gt_idx = np.empty((0,), dtype=np.int64)
    gt_offset = 0
    for seq in seqs:
        seq_dir = osp.join(base_dir, f"seq-{seq:02d}")
        p_files = [n for n in os.listdir(seq_dir) if "pose" in n]
        frame_idx = np.array(sorted(int(n[6:12]) for n in p_files))
        if skip > 1:
            frame_idx = frame_idx[::skip]
        for i in frame_idx:
            poses.append(
                np.loadtxt(osp.join(seq_dir, f"frame-{i:06d}.pose.txt")).flatten()[:12]
            )
            c_imgs.append(osp.join(seq_dir, f"frame-{i:06d}.color.png"))
        gt_idx = np.hstack((gt_idx, gt_offset + frame_idx))
        gt_offset += len(p_files)

    pose_arr = np.asarray(poses, dtype=np.float32).reshape(-1, 3, 4)

    images, hists = [], []
    for j, p in enumerate(c_imgs):
        img = downscale_area(read_image(p), df)
        images.append(img)
        if ret_hist:
            hists.append(luminance_histogram(img, hist_bin))
        elif ret_idx:
            idx = j if (train and not fix_idx) else 0
            hists.append(np.full(1, idx, np.int32))
        else:
            hists.append(np.zeros(1, np.int32))
    return Split(
        images=np.stack(images).astype(np.float32),
        poses=pose_arr,
        hists=np.stack(hists).astype(np.int32),
        gt_idx=gt_idx,
    )
