"""The synthetic-scene quality protocol of QUALITY.md on the port (port of
scripts/quality_synthetic.py).

Trains the full-size NeRF-H (D=8 W=128, 64 + 64 samples, bf16, proposal
sampler on, 1024 rays a step) for --epochs (301) on the analytic synthetic
scene (24 train / 6 val views of 48x64, appearance jitter 0.1), then gives
the val PSNR of every render path: the plain renderer and the three kernel
paths (proposal placement with the exact union, coarse placement with the
exact union, proposal placement with the blended CDF). --stage2 then runs
a stage-2 leg (DFNet, triplet, RVS, tinyimg) through FrozenNeRF on the
trained NeRF.

    python -m dfnet_tpu_torch.scripts.quality_synthetic [--epochs 301]
        [--stage2] [--save_ckpt assets/nerfh_synthetic_301.npz]
        [--train_cull_q Q --train_fine_total N --train_cull_warmup E]
        [--netwidth W ...] [--rng_seed S] [--fused_train B] [--device cpu]

Training launches fine_raw_t and raw_bwd_t, the kernel renders
coarse_sigma_t and fine_raw_t, and the stage-2 pre-render and RVS refresh
both sweeps. It runs on the GPU unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.device import resolve_device
from dfnet_tpu_torch.render.fast import kernels_serve, render_image_fast
from dfnet_tpu_torch.render.volume import render_image
from dfnet_tpu_torch.training.checkpoints import params_to_numpy, save_pytree
from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer

# the flags passed through to the stage-1 config, as the JAX script does
PASS_THROUGH = ("--train_cull_q", "--train_fine_total", "--train_cull_warmup",
                "--netwidth", "--netwidth_fine", "--netdepth", "--netdepth_fine",
                "--rng_seed", "--fused_train")
SCENE = dict(n_train=24, n_val=6, H=48, W=64, focal=60.0, seed=0, appearance_jitter=0.1)
CHUNK = 4096
LOG_EVERY = 50
STAGE2_EPOCHS = 12
# label -> render_image_fast keywords; "plain" is the plain renderer
PATHS = {
    "plain renderer (64 coarse + sorted 64+64 fine)": None,
    "kernels + proposal placement (exact union)": dict(exact_union=True, use_proposal=True),
    "kernels + coarse placement (exact union)": dict(exact_union=True, use_proposal=False),
    "kernels + proposal placement (blended cdf)": dict(exact_union=False, use_proposal=True),
}


def make_scene(device):
    return make_synthetic_scene(**SCENE, device=device)


def stage1_config(extra, device: str):
    return parse_args(["--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
                       "--precision", "bf16", "--N_rand", "1024", "--device", device,
                       *extra], stage="nerf")


def train(cfg, scene, epochs: int) -> NeRFTrainer:
    """Stage 1 from the seeded init for `epochs` epochs."""
    tr = NeRFTrainer(cfg, scene)
    t0 = time.time()
    for e in range(epochs):
        loss, psnr = tr.train_epoch(e)
        if e % LOG_EVERY == 0:
            print(f"epoch {e}: loss {loss:.4f} train-psnr {psnr:.2f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    if tr.device.type == "cuda":
        torch.cuda.synchronize()
    print(f"trained {epochs} epochs in {time.time() - t0:.0f}s "
          f"({tr.uses_fused_train and 'kernel' or 'plain'} step)", flush=True)
    return tr


def val_psnrs(tr: NeRFTrainer, scene) -> Dict[str, float]:
    """Val PSNR of each render path on the trainer's params (test
    settings); the kernel paths only where kernels_serve."""
    params, model, settings = tr.params, tr.model, tr.settings_test
    H, W, focal = scene.H, scene.W, scene.focal
    dev = tr.device
    out = {}
    for label, kw in PATHS.items():
        if kw is not None and not kernels_serve(model, settings):
            print("kernel paths unsupported for this config (see "
                  "kernels_serve): plain render only", flush=True)
            break
        ps = []
        for i in range(len(scene.val)):
            pose = torch.as_tensor(scene.val.poses[i], device=dev)
            hist = torch.as_tensor(scene.val.hists[i], device=dev)
            if kw is None:
                rgb = render_image(params, model, pose, hist, H, W, focal, settings,
                                   chunk=CHUNK)["rgb"]
            else:
                rgb = render_image_fast(params, model, pose, hist, H, W, focal, settings,
                                        chunk=CHUNK, **kw)["rgb"]
            rgb = rgb.float().cpu().numpy()
            ps.append(-10 * np.log10(np.mean((rgb - scene.val.images[i]) ** 2)))
        out[label] = float(np.mean(ps))
        print(f"{label}: val PSNR {out[label]:.3f} dB", flush=True)
    return out


def stage2(tr: NeRFTrainer, scene, epochs: int, device: str) -> Dict:
    """The stage-2 leg: DFNet with the triplet loss and RVS through
    FrozenNeRF on the trained params; returns the pre-render s, the last
    epoch's train loss, the val loss and the median error."""
    from dfnet_tpu_torch.training.feature_trainer import FeatureTrainer
    from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF

    with tempfile.TemporaryDirectory() as tmp:     # the trainer's basedir; nothing is saved
        fcfg = parse_args(["--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
                           "--precision", "bf16", "--model_name", "dfnet", "--DFNet",
                           "--featurenet_batch_size", "4", "--tripletloss",
                           "--random_view_synthesis", "--tinyimg", "--device", device,
                           "--basedir", tmp], stage="feature")
        nerf = FrozenNeRF(fcfg, scene.hwf, scene.near, scene.far, scene.world_setup,
                          params=tr.params, model=tr.model)
        ft = FeatureTrainer(fcfg, scene, nerf=nerf)
    t0 = time.time()
    rgbs = ft.prerender_train_views()
    prerender_s = time.time() - t0
    print(f"stage2 prerender: {prerender_s:.1f}s for {len(scene.train)} views", flush=True)
    np_rng = np.random.default_rng(0)
    targets, rgbs = ft.epoch_images(scene.train.images), ft.epoch_images(rgbs)
    poses_p = virtue = None
    loss = float("nan")
    for e in range(epochs):
        if e % fcfg.rvs_refresh_rate == 0:
            poses_p, virtue = ft.rvs_refresh(np_rng)
            virtue = ft.epoch_images(virtue)
        loss = ft.train_epoch(targets, rgbs, virtue, poses_p, np_rng)
    val = ft.validate()
    print(f"stage2: train loss {loss:.4f} val loss {val:.4f}", flush=True)
    med, _ = ft.eval_median_error()
    return {"prerender_s": prerender_s, "train_loss": float(loss), "val_loss": float(val),
            "median": [float(med[0]), float(med[1])], "epochs": epochs}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=301)
    ap.add_argument("--stage2", action="store_true")
    ap.add_argument("--save_ckpt", default="", help="write the trained params as an .npz")
    ap.add_argument("--device", default="cuda", help="torch device (cpu to opt out of the GPU)")
    for flag in PASS_THROUGH:
        ap.add_argument(flag, default=None)
    return ap


def main(argv: Optional[list] = None) -> Dict:
    args = build_parser().parse_args(argv)
    extra = []
    for flag in PASS_THROUGH:
        value = getattr(args, flag[2:])
        if value is not None:
            extra += [flag, value]
    cfg = stage1_config(extra, args.device)
    scene = make_scene(resolve_device(cfg.device))
    tr = train(cfg, scene, args.epochs)
    if args.save_ckpt:
        save_pytree(args.save_ckpt, params_to_numpy(tr.params))
        print(f"saved params to {args.save_ckpt}", flush=True)
    out = {"epochs": args.epochs, "psnr": val_psnrs(tr, scene)}
    if args.stage2:
        out["stage2"] = stage2(tr, scene, STAGE2_EPOCHS, args.device)
    return out


if __name__ == "__main__":
    main()
