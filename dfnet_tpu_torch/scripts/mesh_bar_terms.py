"""Which terms of the bf16 bar the stage-1 kernel step at world 2 needs.

The kernel step (fine_raw_t / raw_bwd_t, or their plain versions on the
CPU) returns the packed weights' grads in bf16, so at world n each rank's
weighted share is rounded before the float32 all-reduce sums them. This
script runs the stage-1 step of tests/test_torch_port_mesh.py (the D=2
W=32 NeRF-H, 16 + 16 samples, bf16, a 16x20 synthetic scene, params after
24 seeded world-1 steps) at world 1 and at world 2 (two gloo ranks), and
prints, for each case and leaf, the worst |g2 - g1| over u times each of
three growing bounds, u = 2^-8:

  share:        sum_r |share_r|
  +want:        sum_r |share_r| + |g1|
  +scale:       sum_r |share_r| + |g1| + max |g1|

A reading below 1 means that bound covers the measured error. The last
line is one JSON object with the worst reading of each bound over all
cases and leaves.

    python -m dfnet_tpu_torch.scripts.mesh_bar_terms [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.parallel import checks
from dfnet_tpu_torch.parallel.mesh import Mesh, launch
from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer

U = 2.0 ** -8
BOUNDS = ("share", "+want", "+scale")


def small_cfg(device: str, **kw):
    flags = ["--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
             "--netdepth", "2", "--netwidth", "32", "--netdepth_fine", "2",
             "--netwidth_fine", "32", "--N_samples", "16", "--N_importance", "16",
             "--precision", "bf16", "--N_rand", "128", "--chunk", "128",
             "--device", device]
    return parse_args(flags, stage="nerf").replace(**kw)


def trained_params(device: str, scene) -> dict:
    """Params after 24 world-1 steps from the seeded init, as numpy."""
    tr = NeRFTrainer(small_cfg(device, lrate=5e-3), scene)
    for epoch in range(8):
        tr.train_epoch(epoch)

    def host(v):
        if isinstance(v, dict):
            return {k: host(w) for k, w in v.items()}
        return v.detach().cpu().numpy()
    return host(tr.params)


def readings(w1: dict, w2: dict) -> dict:
    """{leaf: [worst ratio under each bound]}."""
    out = {}
    for k, want in w1["grads"].items():
        g = np.asarray(w2["grads"][k], np.float64)
        w = np.asarray(want, np.float64)
        err = np.abs(g - w)
        share = sum(np.abs(np.asarray(s[k], np.float64)) for s in w2["shares"])
        bounds = (share, share + np.abs(w), share + np.abs(w) + max(np.abs(w).max(), 1e-12))
        out[k] = [float(np.max(np.where(err > 0, err / np.maximum(U * b, 1e-300), 0.0)))
                  for b in bounds]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    scene = make_synthetic_scene(n_train=3, n_val=2, H=16, W=20, focal=18.0, seed=0)
    params = trained_params(args.device, scene)
    cases = {
        "perturb_off": dict(cfg=small_cfg(args.device, perturb=0.0), idx=1),
        "perturb_on": dict(cfg=small_cfg(args.device, perturb=1.0, raw_noise_std=0.5), idx=2),
        "uneven": dict(cfg=small_cfg(args.device, perturb=1.0, N_rand=77), idx=0),
    }
    jobs = [("stage1_step", dict(kw, scene=scene, params=params)) for kw in cases.values()]
    mesh = Mesh(2, args.device)
    world2 = launch(checks.run_all, mesh, [(f, dict(kw, mesh=mesh)) for f, kw in jobs])
    world1 = checks.run_all(jobs)
    worst = dict.fromkeys(BOUNDS, 0.0)
    for name, w1, w2 in zip(cases, world1, world2):
        for leaf, r in sorted(readings(w1, w2).items()):
            print(f"{name:12s} {leaf:32s} " + " ".join(f"{b}={v:.4f}"
                                                      for b, v in zip(BOUNDS, r)))
            worst = {b: max(worst[b], v) for b, v in zip(BOUNDS, r)}
    print(json.dumps(worst))
    return worst


if __name__ == "__main__":
    main()
