"""Stage 2 CLI — train and evaluate DFNet (feature extractor + pose
regressor) on the GPU.

    python -m dfnet_tpu_torch.cli.feature --config configs/config_dfnet.txt --basedir <dir>
    python -m dfnet_tpu_torch.cli.feature ... --eval --pretrain_model_path <ckpt.npz>

Port of dfnet_tpu/cli/feature.py with the same flags and config files,
plus `--device` (default `cuda`; `--device cpu` runs on the CPU). The
frozen NeRF is the newest stage-1 checkpoint of <basedir>/<expname>; every
train view is pre-rendered through it, the RVS views are rendered again
every rvs_refresh_rate epochs, and each epoch prints its train and val
loss, appends to <basedir>/<model_name>/metrics.jsonl and hands the val
loss to ReduceLROnPlateau and EarlyStopping (which writes the
checkpoints); every i_eval epochs it prints the val median pose error.
`--eval` prints the median error of a checkpoint (`.npz` of either
package, or the reference's `.pt`). `--prefetch N` keeps the train images
on the host and copies each batch to the GPU N batches ahead of the step
(data/prefetch.py). `--render_feature_only` writes the saliency maps of
every train view and its render to ./tmp/features/{target,rgb}/NNNN.png,
relative to the working directory. `--vgg_init_path` starts the encoder
from a torchvision VGG16 state-dict file. `--check_numerics` raises
FloatingPointError at the first step with a non-finite loss.
`--mesh_shape n` (n > 1) runs n ranks (parallel/mesh.py; NCCL, one a GPU,
or gloo processes under `--device cpu`): the pre-render splits each view's
rays, each step splits its images' encoder, and rank 0 prints and writes.
"""

import os
import os.path as osp

import numpy as np
import torch

from dfnet_tpu_torch.config import apply_runtime_flags, parse_args
from dfnet_tpu_torch.data.loader import load_scene
from dfnet_tpu_torch.device import resolve_device
from dfnet_tpu_torch.models.dfnet import dfnet_forward
from dfnet_tpu_torch.parallel.mesh import agree, is_main, launch, mesh_from_config
from dfnet_tpu_torch.training.feature_trainer import FeatureTrainer
from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF
from dfnet_tpu_torch.utils.metrics_logger import MetricsLogger
from dfnet_tpu_torch.utils.visualization import save_image_saliancy_single


def dump_args(cfg):
    if not is_main():
        return
    expdir = osp.join(cfg.basedir, cfg.expname)
    os.makedirs(expdir, exist_ok=True)
    with open(osp.join(expdir, "args.txt"), "w") as fh:
        for k in sorted(vars(cfg)):
            fh.write(f"{k} = {getattr(cfg, k)}\n")


@torch.no_grad()
def render_features(cfg, scene, trainer, out_root="./tmp/features"):
    """Per-view saliency maps of DFNet's features for the real and the
    rendered image (reference run_feature.py:313-346): channel 2 of level 0
    of each, an eval-mode float32 forward, at
    <out_root>/{target,rgb}/NNNN.png."""
    rgbs = trainer.prerender_train_views()
    if not is_main():
        return
    tr = scene.train
    for sub in ("target", "rgb"):
        os.makedirs(osp.join(out_root, sub), exist_ok=True)
    save_i = 2  # feature channel to dump
    for i in range(len(tr)):
        x = trainer.images(np.stack([tr.images[i], rgbs[i]]))
        feats, _, _ = dfnet_forward(
            trainer.params, trainer.state, x, trainer.model_cfg, return_feature=True,
            is_single_stream=False, return_pose=False, upsample_h=scene.H,
            upsample_w=scene.W)
        # (L, B, C, H, W) stacks of the target and the render
        save_image_saliancy_single(feats[0][0, 0, save_i],
                                   osp.join(out_root, "target", f"{i:04d}.png"))
        save_image_saliancy_single(feats[1][0, 0, save_i],
                                   osp.join(out_root, "rgb", f"{i:04d}.png"))
    print("render features done")


def train(argv=None, mesh=None):
    """Runs the stage; returns the last (median, mean) pose error it
    measured, or None when no eval ran (rank 0's on a mesh). `mesh`
    (parallel/mesh.py) replaces --mesh_shape's, e.g. a share_device mesh of
    ranks on one GPU."""
    cfg = parse_args(argv, stage="feature")
    mesh = mesh if mesh is not None else mesh_from_config(cfg)
    if mesh is not None:
        return launch(run, mesh, cfg, mesh)
    return run(cfg, None)


def run(cfg, mesh=None):
    """The stage on this process: alone (mesh None), or as this rank of
    `mesh` inside parallel/mesh.py::launch."""
    with apply_runtime_flags(cfg):
        return _run(cfg, mesh)


def _run(cfg, mesh):
    device = resolve_device(mesh.device() if mesh is not None else cfg.device)
    if cfg.dataset_type not in ("7Scenes", "Cambridge", "synthetic"):
        print("Unknown dataset type", cfg.dataset_type, "exiting")
        return None
    scene = load_scene(cfg, stage="apr")
    print(f"[run_feature] NEAR FAR {scene.near} {scene.far} "
          f"train={len(scene.train)} val={len(scene.val)} device={device} "
          f"world={mesh.size if mesh is not None else 1}")
    nerf = None
    if not cfg.eval:
        nerf = FrozenNeRF.from_experiment(cfg, scene.hwf, scene.near, scene.far,
                                          scene.world_setup, mesh=mesh, device=device)
    trainer = FeatureTrainer(cfg, scene, nerf, device=device, mesh=mesh)

    if cfg.eval:
        return trainer.eval_median_error(scene.val)

    if cfg.render_feature_only:
        render_features(cfg, scene, trainer)
        return None

    dump_args(cfg)
    targets = trainer.epoch_images(scene.train.images)
    rgbs = trainer.epoch_images(trainer.prerender_train_views())
    mlog = MetricsLogger(osp.join(cfg.basedir, cfg.model_name or "dfnet"))
    rng = np.random.default_rng(cfg.rng_seed)
    poses_perturb = virtue_view = err = None
    for epoch in range(cfg.epochs + 1):
        if cfg.random_view_synthesis and epoch % cfg.rvs_refresh_rate == 0:
            poses_perturb, virtue_view = trainer.rvs_refresh(rng)
            virtue_view = trainer.epoch_images(virtue_view)
        train_loss = trainer.train_epoch(targets, rgbs, virtue_view, poses_perturb, rng)
        # every rank takes the schedule's and early stopping's decisions
        # on the same values
        train_loss, val_loss = agree(train_loss, trainer.validate())
        trainer.scheduler.step(val_loss)
        print(f"At epoch {epoch:6d} : train loss: {train_loss:.4f}, "
              f"val loss: {val_loss:.4f}")
        mlog.log(epoch, train_loss=train_loss, val_loss=val_loss, lr=trainer.scheduler.lr,
                 world=mesh.size if mesh is not None else 1)
        trainer.early_stopping(val_loss, trainer.checkpoint_tree(), epoch=epoch,
                               save_multiple=(not cfg.no_save_multiple),
                               save_all=cfg.save_all_ckpt)
        if trainer.early_stopping.early_stop:
            print("Early stopping")
            break
        if epoch % cfg.i_eval == 0:
            err = trainer.eval_median_error(scene.val)
    return err


main = train

if __name__ == "__main__":
    main()
