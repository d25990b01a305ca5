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
`--eval` prints the median error of a checkpoint. `--prefetch N` keeps
the train images on the host and copies each batch to the GPU N batches
ahead of the step (data/prefetch.py). `--render_feature_only`, a `.pt`
checkpoint, `--vgg_init_path` and a `--mesh_shape` above 1 come with later
slices of the port (ROADMAP.md) and raise NotImplementedError.
"""

import os
import os.path as osp

import numpy as np

from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.loader import load_scene
from dfnet_tpu_torch.device import resolve_device
from dfnet_tpu_torch.training.feature_trainer import FeatureTrainer
from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF
from dfnet_tpu_torch.utils.metrics_logger import MetricsLogger


def dump_args(cfg):
    expdir = osp.join(cfg.basedir, cfg.expname)
    os.makedirs(expdir, exist_ok=True)
    with open(osp.join(expdir, "args.txt"), "w") as fh:
        for k in sorted(vars(cfg)):
            fh.write(f"{k} = {getattr(cfg, k)}\n")


def train(argv=None):
    """Runs the stage; returns the last (median, mean) pose error it
    measured, or None when no eval ran."""
    cfg = parse_args(argv, stage="feature")
    device = resolve_device(cfg.device)
    if cfg.render_feature_only:
        raise NotImplementedError(
            "--render_feature_only needs the saliency-map writer, which is not "
            "ported yet (ROADMAP.md, Queue 1 item 6)")
    if cfg.dataset_type not in ("7Scenes", "Cambridge", "synthetic"):
        print("Unknown dataset type", cfg.dataset_type, "exiting")
        return None
    scene = load_scene(cfg, stage="apr")
    print(f"[run_feature] NEAR FAR {scene.near} {scene.far} "
          f"train={len(scene.train)} val={len(scene.val)} device={device}")
    nerf = None
    if not cfg.eval:
        nerf = FrozenNeRF.from_experiment(cfg, scene.hwf, scene.near, scene.far,
                                          scene.world_setup, device=device)
    trainer = FeatureTrainer(cfg, scene, nerf, device=device)

    if cfg.eval:
        return trainer.eval_median_error(scene.val)

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
        val_loss = trainer.validate()
        trainer.scheduler.step(val_loss)
        print(f"At epoch {epoch:6d} : train loss: {train_loss:.4f}, "
              f"val loss: {val_loss:.4f}")
        mlog.log(epoch, train_loss=train_loss, val_loss=val_loss, lr=trainer.scheduler.lr)
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
