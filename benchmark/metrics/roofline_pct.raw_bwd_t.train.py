"""raw_bwd_t (ops/csrc/raw_bwd.cu) in the train step, its three launches
bwd_stash, bwd_wgrad and bwd_reduce summed, for the static and the fine
sweep: the bound of its launches over their device time."""

from benchmark import readers

NAME = "roofline_pct.raw_bwd_t.train"
UNIT = "%"
LAYER = "CUDA kernels ops/csrc"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
WORKLOADS = ["nerfh_w256.train"]


def read(run):
    return readers.roofline_pct(run, "raw_bwd_t")
