"""Stage-2 convergence, feature_precision bf16 against fp32, on the port
(port of scripts/quality_stage2_precision.py).

Loads a trained stage-1 NeRF-H (--ckpt, by default the 301-epoch asset
assets/nerfh_synthetic_301.npz that quality_synthetic.py --save_ckpt
writes) and runs the same stage-2 DFNet training (triplet + RVS through
FrozenNeRF, seeds fixed) once per precision on the synthetic scene,
printing each one's train loss, val loss and median pose error.

    python -m dfnet_tpu_torch.scripts.quality_stage2_precision [--epochs 12]
        [--only bf16|fp32] [--ckpt path.npz] [--device cpu]

It runs on the GPU unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import os.path as osp
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.device import resolve_device
from dfnet_tpu_torch.models.factory import create_nerfh
from dfnet_tpu_torch.scripts.quality_synthetic import make_scene
from dfnet_tpu_torch.training.checkpoints import load_pytree, params_from_numpy
from dfnet_tpu_torch.training.feature_trainer import FeatureTrainer
from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF

CKPT = osp.join(osp.dirname(osp.abspath(__file__)), "..", "..", "assets",
                "nerfh_synthetic_301.npz")


def run(precision: str, epochs: int, ckpt: str, device: str, scene) -> Dict:
    """One stage-2 run at feature_precision `precision`; returns its last
    epoch's train loss, the val loss and the median error."""
    with tempfile.TemporaryDirectory() as tmp:     # the trainer's basedir; nothing is saved
        fcfg = parse_args([
            "--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
            "--precision", "bf16", "--model_name", f"dfnet_{precision}",
            "--DFNet", "--featurenet_batch_size", "4", "--tripletloss",
            "--random_view_synthesis", "--tinyimg",
            "--feature_precision", precision, "--device", device, "--basedir", tmp,
        ], stage="feature")
        dev = resolve_device(fcfg.device)
        model, _ = create_nerfh(fcfg, torch.Generator().manual_seed(0), dev)
        tree, _ = load_pytree(ckpt)
        params = params_from_numpy(tree.get("params", tree), dev)
        nerf = FrozenNeRF(fcfg, scene.hwf, scene.near, scene.far, scene.world_setup,
                          params=params, model=model)
        ft = FeatureTrainer(fcfg, scene, nerf=nerf, gen=torch.Generator().manual_seed(7))
    t0 = time.time()
    rgbs = ft.epoch_images(ft.prerender_train_views())
    print(f"[{precision}] prerender {time.time() - t0:.1f}s", flush=True)
    np_rng = np.random.default_rng(0)
    targets = ft.epoch_images(scene.train.images)
    poses_p = virtue = None
    loss = float("nan")
    t0 = time.time()
    for e in range(epochs):
        if e % fcfg.rvs_refresh_rate == 0:
            poses_p, virtue = ft.rvs_refresh(np_rng)
            virtue = ft.epoch_images(virtue)
        loss = ft.train_epoch(targets, rgbs, virtue, poses_p, np_rng)
    dt = time.time() - t0
    med, _ = ft.eval_median_error()
    val = ft.validate()
    print(f"[{precision}] {epochs} epochs in {dt:.1f}s "
          f"({dt / max(epochs, 1):.2f} s/epoch incl. host glue): "
          f"train loss {loss:.4f} val loss {val:.4f} "
          f"median err {med[0]:.3f} m / {med[1]:.2f} deg", flush=True)
    return {"train_loss": float(loss), "val_loss": float(val),
            "median": [float(med[0]), float(med[1])], "seconds": dt}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--only", choices=["bf16", "fp32"], default=None)
    ap.add_argument("--ckpt", default=CKPT, help="stage-1 params (.npz)")
    ap.add_argument("--device", default="cuda", help="torch device (cpu to opt out of the GPU)")
    return ap


def main(argv: Optional[list] = None) -> Dict:
    a = build_parser().parse_args(argv)
    scene = make_scene(resolve_device(a.device))
    return {p: run(p, a.epochs, a.ckpt, a.device, scene)
            for p in ([a.only] if a.only else ["bf16", "fp32"])}


if __name__ == "__main__":
    main()
