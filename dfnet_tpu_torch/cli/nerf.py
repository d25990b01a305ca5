"""Stage 1 CLI — train and evaluate the Histogram-assisted NeRF on the GPU.

    python -m dfnet_tpu_torch.cli.nerf --config configs/config_synthetic.txt --basedir <dir>
    python -m dfnet_tpu_torch.cli.nerf --config configs/config_synthetic.txt --basedir <dir> --render_test

Port of dfnet_tpu/cli/nerf.py with the same flags and config files, plus
`--device` (default `cuda`; `--device cpu` runs on the CPU). Without
`--render_test` it trains from the newest checkpoint in
<basedir>/<expname> (or from scratch): a `[TRAIN]` line and a
`metrics.jsonl` record per epoch, a checkpoint every `i_weights` epochs and
eval renders every `i_testset` epochs. `--render_test` resumes the newest
checkpoint, renders the train and val splits and prints their mean PSNRs.
`--render_pose_only` and `--render_video_*` come with a later slice of the
port (ROADMAP.md).
"""

import os
import os.path as osp
import time

from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.loader import load_scene
from dfnet_tpu_torch.device import resolve_device
from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer, exp_decayed_lr
from dfnet_tpu_torch.utils.metrics_logger import MetricsLogger


def dump_args(cfg):
    expdir = osp.join(cfg.basedir, cfg.expname)
    os.makedirs(expdir, exist_ok=True)
    with open(osp.join(expdir, "args.txt"), "w") as fh:
        for k in sorted(vars(cfg)):
            fh.write(f"{k} = {getattr(cfg, k)}\n")
    if cfg.config:
        with open(cfg.config) as src, open(osp.join(expdir, "config.txt"), "w") as fh:
            fh.write(src.read())


def train(argv=None):
    """Runs the stage; returns the last val PSNR it measured (None when a
    training run made no eval render)."""
    cfg = parse_args(argv, stage="nerf")
    device = resolve_device(cfg.device)
    if cfg.render_pose_only:
        raise NotImplementedError(
            "--render_pose_only is not ported yet (ROADMAP.md, Queue 1)")
    if cfg.render_video_train or cfg.render_video_test:
        raise NotImplementedError(
            "--render_video_* is not ported yet (ROADMAP.md, Queue 1)")
    print(f"[run_nerf] dataset={cfg.dataset_type} datadir={cfg.datadir} "
          f"device={device}")
    scene = load_scene(cfg, stage="nerf")
    print(f"[run_nerf] NEAR FAR {scene.near} {scene.far} "
          f"train={len(scene.train)} val={len(scene.val)} hwf={scene.hwf}")
    trainer = NeRFTrainer(cfg, scene, device=device)
    start = trainer.try_resume()
    expdir = osp.join(cfg.basedir, cfg.expname)

    if cfg.render_test:
        tdir = osp.join(expdir, f"evaluate_train_test_{start:06d}")
        vdir = osp.join(expdir, f"evaluate_val_test_{start:06d}")
        p_train = trainer.render_split(scene.train, savedir=tdir)
        print(f"Mean PSNR of train run is: {p_train}")
        p_val = trainer.render_split(scene.val, savedir=vdir)
        print(f"Mean PSNR of this run is: {p_val}")
        return p_val

    print(f"[run_nerf] train step: "
          f"{'kernels (fused_train)' if trainer.uses_fused_train else 'plain render'}")
    dump_args(cfg)
    mlog = MetricsLogger(expdir)
    p_val = None
    for epoch in range(start, cfg.epochs + 1):
        t0 = time.time()
        loss, psnr = trainer.train_epoch(epoch)
        dt = time.time() - t0
        lr = exp_decayed_lr(cfg, epoch)
        mlog.log(epoch, loss=loss, psnr=psnr, lr=lr, epoch_s=dt)
        if epoch % cfg.i_print == 0:
            print(f"[TRAIN] Iter: {epoch} Loss: {loss:.5f}  PSNR: {psnr:.3f}  "
                  f"lr: {lr:.2e}  ({dt:.1f}s)")
        if epoch % cfg.i_weights == 0 and epoch != 0:
            print("Saved checkpoints at", trainer.save(epoch))
        if epoch % cfg.i_testset == 0 and epoch > 0:
            p_tr = trainer.render_split(
                scene.train, savedir=osp.join(expdir, f"trainset_{epoch:06d}"),
                stride=10)
            p_val = trainer.render_split(
                scene.val, savedir=osp.join(expdir, f"testset_{epoch:06d}"))
            print(f"[EVAL] epoch {epoch}: train PSNR {p_tr:.3f}, val PSNR {p_val:.3f}")
    return p_val


main = train

if __name__ == "__main__":
    main()
