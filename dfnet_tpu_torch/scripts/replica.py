"""Write on-disk replicas of the 7-Scenes and Cambridge datasets, in their
own layouts and at their own frame sizes, for runs without the real data.

    python -m dfnet_tpu_torch.scripts.replica --root <dir> [--dataset 7Scenes]
        [--scene heads] [--n_frames 200] [--seed 0] [--device cuda]

Each frame is the synthetic blob field (data/synthetic.py) rendered at the
dataset's focal (585 for 7-Scenes, 744 for Cambridge) from a pose on a
viewing sphere, each sequence or split from its own pose seed, written as
an 8-bit PNG by data/png.py::write_png. The pose file holds the pose that
the loader's coordinate fix maps back onto the sphere pose: with the
replica's identity pose_avg_stats.txt and its unit world_setup.json
scales, the NeRF-frame poses data/loader.py::load_scene returns are the
poses the frames were rendered at. Then `--datadir <dir>/7Scenes/<scene>`
(or `<dir>/Cambridge/<scene>`) runs the shipped configs:

  <dir>/deepslam_data/7Scenes/<scene>/seq-01, seq-02/frame-%06d.{color.png,pose.txt}
  <dir>/deepslam_data/7Scenes/<scene>/{TrainSplit.txt (sequence2), TestSplit.txt (sequence1)}
  <dir>/deepslam_data/Cambridge/<scene>/{train,test}/{rgb/frame%05d.png, poses/frame%05d.txt}
  <dir>/<dataset>/<scene>/{world_setup.json, pose_avg_stats.txt}

The frames render on `device` (float64 quadrature, 192 samples a ray): at
full size that takes the GPU, so the CPU tests write small replicas.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time
from typing import Dict

import numpy as np

from dfnet_tpu_torch.data.png import write_png
from dfnet_tpu_torch.data.synthetic import make_blob_field, render_gt_image, sphere_poses
from dfnet_tpu_torch.device import resolve_device
from dfnet_tpu_torch.models.losses import to8b
from dfnet_tpu_torch.pose.se3 import FLIP_YZ, rot_phi

NEAR, FAR, RADIUS = 0.5, 3.5, 2.0
WORLD_SETUP = {"near": NEAR, "far": FAR, "pose_scale": 1.0, "pose_scale2": 1.0,
               "move_all_cam_vec": [0.0, 0.0, 0.0]}


def _homo(poses: np.ndarray) -> np.ndarray:
    out = np.tile(np.eye(4), (len(poses), 1, 1))
    out[:, :3] = poses
    return out


def unfix_7scenes(poses: np.ndarray) -> np.ndarray:
    """(N, 4, 4) file poses whose fix_coord_7scenes (identity average) is
    the (N, 3, 4) `poses`: M P M with M = diag(1, -1, -1, 1), its own inverse."""
    return FLIP_YZ[None] @ _homo(np.asarray(poses, np.float64)) @ FLIP_YZ[None]


def unfix_cambridge(poses: np.ndarray) -> np.ndarray:
    """(N, 4, 4) file poses whose fix_coord_cambridge (identity average) is
    the (N, 3, 4) `poses`. The fix maps [R | t] to [-Rx R D | Rx t], with Rx
    the 180 degree rotation about x and D = diag(-1, 1, 1)."""
    rx_inv = np.linalg.inv(rot_phi(np.pi))[:3, :3]
    s = np.asarray(poses, np.float64)
    out = np.tile(np.eye(4), (len(s), 1, 1))
    out[:, :3, :3] = -rx_inv[None] @ s[:, :3, :3] @ np.diag([-1.0, 1.0, 1.0])[None]
    out[:, :3, 3] = (rx_inv[None] @ s[:, :3, 3:])[..., 0]
    return out


def _write_meta(meta_dir: str) -> None:
    os.makedirs(meta_dir, exist_ok=True)
    with open(osp.join(meta_dir, "world_setup.json"), "w") as fh:
        json.dump(WORLD_SETUP, fh)
    np.savetxt(osp.join(meta_dir, "pose_avg_stats.txt"), np.eye(4)[:3])


def _render_frames(field, poses, H, W, focal, device) -> np.ndarray:
    return np.stack([to8b(render_gt_image(field, p, H, W, focal, NEAR, FAR, device=device))
                     for p in poses])


def write_seven_scenes_replica(root: str, scene: str = "heads", n_frames: int = 200,
                               H: int = 480, W: int = 640, seed: int = 0,
                               device="cpu") -> Dict:
    """The MSR layout of one 7-Scenes scene with two sequences of n_frames
    (seq-02 the train split, seq-01 the test split, as in heads). Returns
    {"datadir", "frames": {seq: (n, H, W, 3) uint8}, "poses": {seq: (n, 3, 4)
    sphere poses}}."""
    field = make_blob_field(seed)
    img_dir = osp.join(root, "deepslam_data", "7Scenes", scene)
    frames, poses = {}, {}
    for seq in (1, 2):
        seq_dir = osp.join(img_dir, f"seq-{seq:02d}")
        os.makedirs(seq_dir, exist_ok=True)
        poses[seq] = sphere_poses(n_frames, RADIUS, seed=seed + 10 * seq)
        frames[seq] = _render_frames(field, poses[seq], H, W, 585.0, device)
        for f, (img, pose) in enumerate(zip(frames[seq], unfix_7scenes(poses[seq]))):
            write_png(osp.join(seq_dir, f"frame-{f:06d}.color.png"), img)
            np.savetxt(osp.join(seq_dir, f"frame-{f:06d}.pose.txt"), pose)
    with open(osp.join(img_dir, "TrainSplit.txt"), "w") as fh:
        fh.write("sequence2\n")
    with open(osp.join(img_dir, "TestSplit.txt"), "w") as fh:
        fh.write("sequence1\n")
    meta_dir = osp.join(root, "7Scenes", scene)
    _write_meta(meta_dir)
    return {"datadir": meta_dir, "frames": frames, "poses": poses}


def write_cambridge_replica(root: str, scene: str = "KingsCollege", n_frames: int = 200,
                            H: int = 480, W: int = 854, seed: int = 0,
                            device="cpu") -> Dict:
    """The pre-extracted Cambridge layout of one scene, n_frames in each of
    the train and test splits. Returns {"datadir", "frames": {split: (n, H,
    W, 3) uint8}, "poses": {split: (n, 3, 4) sphere poses}}."""
    field = make_blob_field(seed)
    frames, poses = {}, {}
    for k, split in enumerate(("train", "test")):
        base = osp.join(root, "deepslam_data", "Cambridge", scene, split)
        os.makedirs(osp.join(base, "rgb"), exist_ok=True)
        os.makedirs(osp.join(base, "poses"), exist_ok=True)
        poses[split] = sphere_poses(n_frames, RADIUS, seed=seed + 10 * (k + 1))
        frames[split] = _render_frames(field, poses[split], H, W, 744.0, device)
        for i, (img, pose) in enumerate(zip(frames[split], unfix_cambridge(poses[split]))):
            write_png(osp.join(base, "rgb", f"frame{i:05d}.png"), img)
            np.savetxt(osp.join(base, "poses", f"frame{i:05d}.txt"), pose)
    meta_dir = osp.join(root, "Cambridge", scene)
    _write_meta(meta_dir)
    return {"datadir": meta_dir, "frames": frames, "poses": poses}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--dataset", choices=("7Scenes", "Cambridge"), default="7Scenes")
    ap.add_argument("--scene", default=None, help="heads (7Scenes) or KingsCollege")
    ap.add_argument("--n_frames", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    write = (write_seven_scenes_replica if args.dataset == "7Scenes"
             else write_cambridge_replica)
    scene = args.scene or ("heads" if args.dataset == "7Scenes" else "KingsCollege")
    t0 = time.perf_counter()
    out = write(args.root, scene=scene, n_frames=args.n_frames, seed=args.seed,
                device=device)
    print(f"[replica] {args.dataset}/{scene}: {2 * args.n_frames} frames in "
          f"{time.perf_counter() - t0:.1f} s; --datadir {out['datadir']}")


if __name__ == "__main__":
    main()
