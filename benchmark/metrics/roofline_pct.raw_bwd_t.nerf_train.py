"""raw_bwd_t (ops/csrc/raw_bwd.cu) in the original NeRF's stage-1 train cell, its three
launches bwd_stash, bwd_wgrad and bwd_reduce summed, for both nets' static
sweeps: the bound of its launches over their device time."""

from benchmark import readers

NAME = "roofline_pct.raw_bwd_t.nerf_train"
UNIT = "%"
LAYER = "CUDA kernels ops/csrc"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
WORKLOADS = ["nerf_vanilla.train"]


def read(run):
    return readers.roofline_pct(run, "raw_bwd_t")
