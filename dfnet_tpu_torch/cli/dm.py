"""Stage 3 CLI — DFNet_dm direct-feature-matching fine-tuning and eval on
the GPU.

    python -m dfnet_tpu_torch.cli.dm --config configs/config_dfnetdm.txt \
        --pretrain_model_path <stage-2 ckpt.npz> [--device cpu]
    python -m dfnet_tpu_torch.cli.dm ... --eval --pretrain_model_path <ckpt.npz>

Port of dfnet_tpu/cli/dm.py with the same flags and config files, plus
`--device` (default `cuda`; `--device cpu` runs on the CPU). The frozen
NeRF is the newest stage-1 checkpoint of <basedir>/<expname>, rendered at
quarter resolution and bicubic-upsampled (tinyimg, tinyscale 4, as the
reference hardcodes). Each epoch prints its train and val loss and PSNR,
appends to <basedir>/<model_name>/metrics.jsonl and hands the val loss
(or PSNR, under val_on_psnr) to EarlyStopping, which writes the
checkpoints; every i_eval epochs it prints the val median pose error.
`--eval` prints the median error of a checkpoint. The DFNet checkpoints
may be `.npz` files of either package or the reference's `.pt`, the NeRF
(`--ft_path`, or NNNNNN.tar in the expdir) the reference's `.tar`.
`--prefetch N` feeds each step from the host through data/prefetch.py.
`--check_numerics` raises FloatingPointError at the first step with a
non-finite loss. `--mesh_shape` above 1 comes with a later slice of the
port (ROADMAP.md) and raises NotImplementedError.
"""

import os.path as osp

import numpy as np
import torch

from dfnet_tpu_torch.config import apply_runtime_flags, parse_args
from dfnet_tpu_torch.data.loader import load_scene
from dfnet_tpu_torch.device import resolve_device
from dfnet_tpu_torch.models.dfnet import DFNetConfig, dfnet_forward
from dfnet_tpu_torch.training.dm_trainer import DMTrainer, refuse_unported
from dfnet_tpu_torch.training.eval_pose import get_error_in_q
from dfnet_tpu_torch.training.feature_trainer import load_dfnet_params
from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF
from dfnet_tpu_torch.utils.metrics_logger import MetricsLogger

N_EPOCH = 2001  # hardcoded in the reference (direct_feature_matching.py:437)


def _setup(cfg, device):
    scene = load_scene(cfg, stage="apr")
    print(f"[train] NEAR FAR {scene.near} {scene.far} "
          f"train={len(scene.train)} val={len(scene.val)} device={device}")
    # the reference renders stage 3 at quarter resolution, then upsamples
    # bicubically (direct_feature_matching.py:341-348,414)
    nerf_cfg = cfg.replace(tinyimg=True, tinyscale=4.0)
    nerf = FrozenNeRF.from_experiment(nerf_cfg, scene.hwf, scene.near, scene.far,
                                      scene.world_setup, device=device)
    return scene, nerf


def train(argv=None):
    """Runs the stage; returns the last (median, mean) pose error it
    measured, or None when no eval ran."""
    cfg = parse_args(argv, stage="dm")
    with apply_runtime_flags(cfg):
        return _train(cfg)


def _train(cfg):
    device = resolve_device(cfg.device)
    refuse_unported(cfg)                 # before the scene and the NeRF load
    scene, nerf = _setup(cfg, device)
    trainer = DMTrainer(cfg, scene, nerf, device=device)
    rng = np.random.default_rng(cfg.rng_seed)
    mlog = MetricsLogger(osp.join(cfg.basedir, cfg.model_name or "dfnetdm"))
    err = None
    for epoch in range(min(N_EPOCH, cfg.epochs + 1)):
        loss, psnr = trainer.train_epoch(rng)
        val_loss, val_psnr = trainer.eval_epoch()
        mlog.log(epoch, train_loss=loss, train_psnr=psnr, val_loss=val_loss,
                 val_psnr=val_psnr)
        print(f"At epoch {epoch:4d} : train loss: {loss:.4f}, train psnr: "
              f"{psnr:.4f}, val loss: {val_loss:.4f}, val psnr: {val_psnr:.4f}")
        trainer.early_stopping(val_loss, trainer.checkpoint_tree(), epoch=epoch,
                               save_multiple=(not cfg.no_save_multiple),
                               save_all=cfg.save_all_ckpt, val_psnr=val_psnr)
        if trainer.early_stopping.early_stop:
            print("Early stopping")
            break
        if epoch % cfg.i_eval == 0:
            err = trainer.eval_median_error(scene.val)
    return err


def evaluate(argv=None):
    """Prints and returns the (median, mean) pose error of the
    --pretrain_model_path checkpoint on the val split (float32 DFNet)."""
    cfg = parse_args(argv, stage="dm")
    with apply_runtime_flags(cfg):
        return _evaluate(cfg)


def _evaluate(cfg):
    device = resolve_device(cfg.device)
    scene = load_scene(cfg, stage="apr")
    mcfg = DFNetConfig.small() if cfg.DFNet_s else DFNetConfig()
    params, state = load_dfnet_params(cfg.pretrain_model_path, device)

    @torch.no_grad()
    def predict12(images):
        x = torch.as_tensor(np.asarray(images, np.float32), device=device)
        return dfnet_forward(params, state, x.permute(0, 3, 1, 2), mcfg,
                             return_feature=False)[1]

    print(len(scene.val))
    return get_error_in_q(predict12, scene.val)


def main(argv=None):
    # eval comes from the CLI or from eval = True in the config file
    if parse_args(argv, stage="dm").eval:
        return evaluate(argv)
    return train(argv)


if __name__ == "__main__":
    main()
