"""Pieces the generators share: the launch contract, the scene container the
program takes, and the cell's counters of work for the metric readers."""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from benchmark.frozen import bound_ms

# the device kernels' names (the program's CUDA sources) by wrapper
KERNEL_NAMES = {
    "coarse_sigma_t": ("coarse_sigma_kernel",),
    "fine_raw_t": ("fine_raw_kernel",),
    "fine_composite_t": ("fine_composite_kernel",),
    "raw_bwd_t": ("bwd_stash_kernel", "bwd_wgrad_kernel", "bwd_reduce_kernel"),
}
IDENTITY_WORLD = {"pose_scale": 1.0, "pose_scale2": 1.0, "move_all_cam_vec": [0.0, 0.0, 0.0]}


class Marks:
    """Seconds of the parts of set-up, for its line on standard error."""

    def __init__(self):
        self.t = time.perf_counter()
        self.parts: Dict[str, float] = {}

    def __call__(self, part: str) -> None:
        now = time.perf_counter()
        self.parts[part] = self.parts.get(part, 0.0) + now - self.t
        self.t = now


def check_launches(before: Dict[str, int], after: Dict[str, int], want: Dict[str, int],
                   units: int, what: str) -> None:
    """Stop the run unless `units` units of work launched each kernel of
    the cell's contract `want` (launches a unit) that many times."""
    got = {k: after[k] - before.get(k, 0) for k in want}
    if any(got[k] != v * units for k, v in want.items()):
        raise SystemExit(f"{what}: the cell's launch contract is {want} a unit, "
                         f"{units} units launched {got}")


def kernel_entry(kernel: str, per_unit: int, sweeps) -> Dict:
    """What the roofline readers need of one kernel: its device names, the
    name that counts its launches, launches a unit of work and the bound
    of a unit's launches (the sum over `sweeps`)."""
    names = KERNEL_NAMES[kernel]
    return {"patterns": names, "count": names[0], "per_unit": per_unit,
            "bound_ms": sum(bound_ms(kernel, s) for s in sweeps)}


def program_flags(cfg: Dict) -> list:
    """The stage CLI flags of a configuration file: every key that is a
    field of the program's Config, as `--key value`."""
    import dataclasses

    from dfnet_tpu_torch.config import Config

    fields = {f.name for f in dataclasses.fields(Config)}
    out = []
    for k, v in cfg.items():
        if k in fields:
            vals = v if isinstance(v, list) else [v]
            out += [f"--{k}"] + [str(x).lower() if isinstance(x, bool) else str(x)
                                 for x in vals]
    return out


def scene_data(images, poses, hists, H, W, focal, near, far):
    """The program's SceneData: every frame in the train split, the first
    one in the val split."""
    from dfnet_tpu_torch.data.scene import SceneData, Split

    def split(sl):
        return Split(images=images[sl], poses=poses[sl], hists=hists[sl],
                     gt_idx=np.arange(len(poses))[sl])

    return SceneData(train=split(slice(None)), val=split(slice(0, 1)), hwf=[H, W, focal],
                     near=near, far=far, world_setup=dict(IDENTITY_WORLD), name="synthetic")

