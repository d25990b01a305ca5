"""The data-enabled parity protocol for real 7-Scenes / Cambridge scenes
(port of scripts/parity_7scenes.py): given a scene directory and the
released reference checkpoints, one command runs

  1. the port of the torch checkpoints (.tar NeRF-H, .pt DFNet) through
     dfnet_tpu_torch/convert.py;
  2. the NeRF render of the test split with the plain renderer -> mean PSNR
     (the reference's --render_test protocol, rendering.py:431-457);
  3. DFNet pose regression on the test split -> median and mean
     translation (m) and rotation (deg) errors (pose_model.py:136-173),

for the BASELINE.md comparison:

    python -m dfnet_tpu_torch.scripts.parity_7scenes --datadir data/7Scenes/heads \\
        --nerf_ckpt paper_models/heads_nerfh.tar \\
        --dfnet_ckpt paper_models/checkpoint-0888-0.0025.pt [--device cpu]

The dry run needs no data and runs the whole protocol on miniature
on-disk replicas (scripts/replica.py, 64 x 64 frames): a 7-Scenes scene
in histogram mode, the same scene in index-embedding mode (NeRFH,
encode_hist off) and a Cambridge scene, from checkpoints in the
reference's exact dict naming built from the port's seeded inits, whose
round trip through convert.py is asserted bit for bit first:

    python -m dfnet_tpu_torch.scripts.parity_7scenes --dryrun [--max_render_views 2]

It runs on the GPU unless --device cpu is given; there is no fallback.
"""

from __future__ import annotations

import argparse
import os.path as osp
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.convert import (convert_dfnet_checkpoint, convert_nerf_checkpoint,
                                     export_dfnet_checkpoint, export_nerf_checkpoint)
from dfnet_tpu_torch.data.loader import load_scene
from dfnet_tpu_torch.device import resolve_device
from dfnet_tpu_torch.models.dfnet import DFNetConfig, init_dfnet_params
from dfnet_tpu_torch.models.factory import create_nerfh, render_settings
from dfnet_tpu_torch.render.volume import render_image
from dfnet_tpu_torch.scripts.replica import write_cambridge_replica, write_seven_scenes_replica
from dfnet_tpu_torch.training.checkpoints import load_pytree, params_from_numpy
from dfnet_tpu_torch.training.feature_trainer import FeatureTrainer
from dfnet_tpu_torch.training.nerf_trainer import named_leaves

TINY = ["--netdepth", "2", "--netwidth", "32", "--netdepth_fine", "2",
        "--netwidth_fine", "32", "--N_samples", "16", "--N_importance", "16"]
# the dry run's legs: (dataset_type, encode_hist)
LEGS = (("7Scenes", True), ("7Scenes", False), ("Cambridge", True))
# the dry run's replicas: frames a sequence or split, and their size (64 px
# sides leave >= 32 px at --df 2 for the DFNet eval's five 2x2 pools)
DRY_FRAMES, DRY_H, DRY_W = 6, 64, 64


def port_nerf(path: str, D: int, device) -> Dict:
    """A reference .tar (convert.py) or a shared .npz -> the port's param
    tree on `device`."""
    if path.endswith(".tar"):
        tree, _ = convert_nerf_checkpoint(path, D=D)
    else:
        tree, _ = load_pytree(path)
        tree = tree.get("params", tree)
    return params_from_numpy(tree, device)


def run_protocol(args, dataset_type: str, datadir: str, workdir: Optional[str],
                 nerf_ckpt: str, dfnet_ckpt: str, encode_hist: bool = True) -> Dict:
    """Port the checkpoints, render the test split, evaluate DFNet's pose
    error: the release-validation pipeline for one scene and mode. Returns
    {"psnrs", "median", "mean"}."""
    mode = "hist" if encode_hist else "index"
    tag = f"{dataset_type}/{mode}"
    base = ["--dataset_type", dataset_type, "--datadir", datadir,
            "--NeRFH", "--df", str(args.df), "--device", args.device]
    if encode_hist:
        base += ["--encode_hist"]
    if args.dryrun:
        base += TINY
    ncfg = parse_args(base, stage="nerf")
    device = resolve_device(ncfg.device)

    # ------------------------------------------------ NeRF render PSNR
    scene = load_scene(ncfg, stage="nerf")
    model, params = create_nerfh(ncfg, torch.Generator().manual_seed(0), device)
    if nerf_ckpt:
        loaded = port_nerf(nerf_ckpt, ncfg.netdepth, device)
        for k in params:
            if k not in loaded:
                print(f"[port:{tag}] NeRF ckpt lacks '{k}' — fresh init kept")
                loaded[k] = params[k]
        params = loaded
        print(f"[port:{tag}] NeRF-H weights from {nerf_ckpt}")
    settings = render_settings(ncfg, scene.near, scene.far, test=True)
    H, W, focal = scene.H, scene.W, scene.focal
    split = scene.val
    n_views = len(split)
    if args.max_render_views:
        n_views = min(n_views, args.max_render_views)
    psnrs = []
    for i in range(n_views):
        out = render_image(params, model, torch.as_tensor(split.poses[i], device=device),
                           torch.as_tensor(split.hists[i], device=device), H, W, focal,
                           settings, chunk=min(ncfg.chunk, H * W))
        rgb = out["rgb"].float().cpu().numpy()
        mse = float(np.mean((rgb - split.images[i]) ** 2))
        psnrs.append(-10.0 * np.log10(max(mse, 1e-10)))
        print(f"[nerf:{tag}] view {i + 1}/{n_views}: PSNR {psnrs[-1]:.2f} dB", flush=True)
    print(f"[nerf:{tag}] mean test PSNR: {np.mean(psnrs):.3f} dB "
          "(reference protocol: rendering.py:431-457; paper-scene anchors "
          "in BASELINE.md)")

    # ------------------------------------------------ DFNet pose error
    with tempfile.TemporaryDirectory() as tmp:     # the trainer's basedir; nothing is saved
        fargs = base + ["--model_name", "parity_dfnet", "--DFNet", "--basedir",
                        workdir or tmp]
        if dfnet_ckpt:
            fargs += ["--pretrain_model_path", dfnet_ckpt]
        fcfg = parse_args(fargs, stage="feature")
        apr_scene = load_scene(fcfg, stage="apr")
        ft = FeatureTrainer(fcfg, apr_scene, nerf=None)
    if dfnet_ckpt:
        print(f"[port:{tag}] DFNet weights from {dfnet_ckpt}")
    med, mean = ft.eval_median_error(apr_scene.val)
    print(f"[dfnet:{tag}] median error: {med[0]:.4f} m / {med[1]:.3f} deg; "
          f"mean: {mean[0]:.4f} m / {mean[1]:.3f} deg")
    print(f"[dfnet:{tag}] compare against the paper tables (BASELINE.md: "
          "median within 1 cm / 0.2 deg of the reference checkpoint)")
    return {"psnrs": psnrs, "median": med, "mean": mean}


def _assert_same(got: Dict, want: Dict, what: str) -> None:
    a, b = dict(named_leaves(got)), dict(named_leaves(want))
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: leaves differ: {sorted(a.keys() ^ b.keys())}")
    for k in a:
        x = np.asarray(torch.as_tensor(a[k]).cpu())
        y = np.asarray(torch.as_tensor(b[k]).cpu())
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{what}: leaf {k} changed in the round trip")


def build_replica_ckpts(workdir: str, device, encode_hist: bool = True) -> Tuple[str, str]:
    """Checkpoints in the reference's exact torch formats from the port's
    seeded inits (NeRF-H seed 7, DFNet seed 8), with the convert.py round
    trip asserted bit-exact, so the release code paths run on real
    .tar/.pt inputs without the released files. Returns (tar, pt)."""
    mode = "hist" if encode_hist else "index"
    ncfg = parse_args(["--dataset_type", "synthetic", "--NeRFH"] + TINY
                      + (["--encode_hist"] if encode_hist else []), stage="nerf")
    _, params = create_nerfh(ncfg, torch.Generator().manual_seed(7), device)
    params.pop("proposal", None)              # a .tar holds no proposal net
    tar = osp.join(workdir, f"replica_nerfh_{mode}.tar")
    export_nerf_checkpoint(params, tar, global_step=123)
    back, meta = convert_nerf_checkpoint(tar, D=ncfg.netdepth)
    if meta["global_step"] != 123:
        raise AssertionError(f"{tar}: global_step {meta['global_step']} != 123")
    _assert_same(back, params, tar)
    print(f"[dryrun] replica .tar round-trip bit-exact ({mode} mode): {tar}")

    pt = osp.join(workdir, "replica_dfnet.pt")
    dparams, dstate = init_dfnet_params(torch.Generator().manual_seed(8), DFNetConfig(),
                                        device)
    export_dfnet_checkpoint(dparams, dstate, pt)
    bparams, bstate = convert_dfnet_checkpoint(pt, device)
    _assert_same({"params": bparams, "state": bstate},
                 {"params": dparams, "state": dstate}, pt)
    print(f"[dryrun] replica .pt round-trip bit-exact: {pt}")
    return tar, pt


def dryrun(args, legs: List[Tuple[str, bool]] = LEGS, workdir: Optional[str] = None) -> Dict:
    """The protocol's legs on miniature replicas written under workdir (a
    temporary directory, removed after, by default). Returns {leg:
    run_protocol's result}."""
    if workdir is None:
        with tempfile.TemporaryDirectory(prefix="parity_dryrun_") as tmp:
            return dryrun(args, legs, tmp)
    device = resolve_device(args.device)
    ckpts = {hist: build_replica_ckpts(workdir, device, encode_hist=hist)
             for hist in sorted({h for _, h in legs}, reverse=True)}
    roots = {}
    for dataset in sorted({d for d, _ in legs}):
        write = write_seven_scenes_replica if dataset == "7Scenes" else write_cambridge_replica
        roots[dataset] = write(workdir, n_frames=DRY_FRAMES, H=DRY_H, W=DRY_W,
                               device=device)["datadir"]
    print(f"[dryrun] miniature replicas at {', '.join(roots.values())}")
    out = {}
    for dataset, hist in legs:
        tar, pt = ckpts[hist]
        out[(dataset, hist)] = run_protocol(args, dataset, roots[dataset], workdir, tar, pt,
                                            encode_hist=hist)
    what = " + ".join(f"{d} {'hist' if h else 'index'}" for d, h in legs)
    print(f"PARITY PROTOCOL COMPLETE ({what}, .tar/.pt ports round-tripped)")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--datadir", default="")
    ap.add_argument("--dataset_type", default="7Scenes")
    ap.add_argument("--nerf_ckpt", default="")
    ap.add_argument("--dfnet_ckpt", default="")
    ap.add_argument("--df", type=float, default=2.0)
    ap.add_argument("--max_render_views", type=int, default=0,
                    help="cap rendered test views (0 = all)")
    ap.add_argument("--dryrun", action="store_true",
                    help="run every port+protocol on miniature replicas")
    ap.add_argument("--device", default="cuda", help="torch device (cpu to opt out of the GPU)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.dryrun:
        return dryrun(args)
    out = run_protocol(args, args.dataset_type, args.datadir, None, args.nerf_ckpt,
                       args.dfnet_ckpt)
    print("PARITY PROTOCOL COMPLETE")
    return out


if __name__ == "__main__":
    main()
