"""fine_raw_t (ops/csrc/fine_raw.cu) in the original NeRF's stage-1 train cell, the
coarse (S=64) and the fine (S=192) static sweep together: the bound of its
launches over their device time."""

from benchmark import readers

NAME = "roofline_pct.fine_raw_t.nerf_train"
UNIT = "%"
LAYER = "CUDA kernels ops/csrc"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
WORKLOADS = ["nerf_vanilla.train"]


def read(run):
    return readers.roofline_pct(run, "fine_raw_t")
