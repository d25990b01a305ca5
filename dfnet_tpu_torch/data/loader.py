"""Dataset loader factory (port of dfnet_tpu/data/loader.py): one entry
per (dataset, stage) pairing.

Mirrors the reference contracts load_7Scenes_dataloader(_NeRF)
(reference: dataset_loaders/load_7Scenes.py:422,497) and the Cambridge
equivalents (load_Cambridge.py:349,420):
  - the NeRF stage applies the full coordinate fix INCLUDING the world
    rescale (rescale_coord=True);
  - APR stages (2/3) center and flip only, deferring the rescale to
    train time (rescale_poses_to_nerf on the predicted pose);
  - finetune_unlabel (stage-3 self-supervised) makes the "train" split
    the test sequences subsampled by trainskip (load_7Scenes.py:462-464).
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from dfnet_tpu_torch.config import Config
from dfnet_tpu_torch.data.cambridge import load_cambridge_split
from dfnet_tpu_torch.data.scene import (
    SceneData,
    Split,
    load_pose_avg_stats,
    load_world_setup,
)
from dfnet_tpu_torch.data.seven_scenes import load_seven_scenes_split
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.device import resolve_device
from dfnet_tpu_torch.pose import (
    center_poses,
    fix_coord_7scenes,
    fix_coord_cambridge,
    rescale_poses_to_nerf,
)

FOCAL = {"7Scenes": 585.0, "Cambridge": 744.0}   # at the datasets' full frame size


def _apply_fix_coord(train: Split, val: Split, dataset_type: str,
                     pose_avg, world_setup, rescale_coord: bool):
    all_poses = np.concatenate([train.poses, val.poses], 0)
    if dataset_type == "7Scenes":
        fixed = fix_coord_7scenes(all_poses, pose_avg)
    else:
        fixed = fix_coord_cambridge(all_poses, pose_avg)
    if rescale_coord:
        fixed = rescale_poses_to_nerf(
            fixed, world_setup["pose_scale"], world_setup["move_all_cam_vec"],
            world_setup["pose_scale2"])
    n = len(train.poses)
    train.poses = fixed[:n].astype(np.float32)
    val.poses = fixed[n:].astype(np.float32)


def load_scene(cfg: Config, stage: str = "nerf") -> SceneData:
    """stage: 'nerf' (rescale into NeRF coords) or 'apr' (keep metric frame).

    For 7Scenes and Cambridge, cfg.datadir is <root>/<dataset>/<scene>,
    the folder of world_setup.json and pose_avg_stats.txt; the frames are
    read from <root>/deepslam_data/<dataset>/<scene>."""
    if cfg.dataset_type == "synthetic":
        # 48x64 keeps VGG16's five 2x2 pools valid (each side >= 32)
        scene = make_synthetic_scene(H=48, W=64, focal=60.0, seed=cfg.rng_seed,
                                     device=resolve_device(cfg.device))
        if cfg.NeRFH and not cfg.encode_hist:
            _relabel_with_indices(scene, cfg.fix_index)
        return scene

    if cfg.dataset_type not in FOCAL:
        # before touching the filesystem: a typo'd type would otherwise
        # surface as a missing world_setup.json for the wrong layout
        raise ValueError(f"unknown dataset_type {cfg.dataset_type!r}")

    meta_dir = cfg.datadir.rstrip("/")
    data_root, scene = osp.split(meta_dir)           # ../data/7Scenes, heads
    dataset_folder, dataset = osp.split(data_root)   # ../data, 7Scenes
    img_root = osp.join(dataset_folder, "deepslam_data", dataset)

    world_setup = load_world_setup(meta_dir)
    pose_avg = None
    if cfg.load_pose_avg_stats:
        pose_avg = load_pose_avg_stats(meta_dir)
        if pose_avg is None:
            raise FileNotFoundError(
                f"--load_pose_avg_stats set but {meta_dir}/pose_avg_stats.txt missing")

    read_split = (load_seven_scenes_split if cfg.dataset_type == "7Scenes"
                  else load_cambridge_split)

    def loader(train: bool, skip: int) -> Split:
        return read_split(img_root, scene, train=train, skip=skip, df=cfg.df,
                          hist_bin=cfg.hist_bin, ret_hist=cfg.encode_hist,
                          ret_idx=(cfg.NeRFH and not cfg.encode_hist),
                          fix_idx=cfg.fix_index)

    train = loader(stage == "nerf" or not cfg.finetune_unlabel, cfg.trainskip)
    val = loader(False, cfg.testskip)

    if cfg.save_pose_avg_stats:
        # one-shot utility: compute and store the train-split pose average
        # so all stages share one centering frame (load_7Scenes.py:282-295)
        _, pose_avg_out = center_poses(train.poses.reshape(-1, 3, 4))
        path = osp.join(meta_dir, "pose_avg_stats.txt")
        np.savetxt(path, pose_avg_out)
        print(f"[loader] pose_avg_stats saved to {path}")

    _apply_fix_coord(train, val, cfg.dataset_type, pose_avg, world_setup,
                     rescale_coord=(stage == "nerf"))

    H, W = train.images.shape[1:3]
    return SceneData(
        train=train, val=val, hwf=[H, W, FOCAL[cfg.dataset_type] / cfg.df],
        near=world_setup["near"], far=world_setup["far"],
        world_setup=world_setup, name=scene,
    )


def _relabel_with_indices(scene: SceneData, fix_index: bool):
    """NeRF-W per-image-index embedding labels (NeRFH with
    encode_hist=False): train images carry their split position (or 0
    under --fix_index), val images carry 0."""
    n_tr = len(scene.train)
    tr_idx = np.zeros(n_tr, np.int32) if fix_index else np.arange(n_tr, dtype=np.int32)
    scene.train.hists = tr_idx[:, None]
    scene.val.hists = np.zeros((len(scene.val), 1), np.int32)


def epoch_permutation(n: int, rng: np.random.Generator) -> np.ndarray:
    """The order of one epoch's train images, from the caller's generator."""
    return rng.permutation(n)
