"""fine_raw_t (ops/csrc/fine_raw.cu) in the train step, the static and
the fine sweep together: the bound of its launches over their device time."""

from benchmark import readers

NAME = "roofline_pct.fine_raw_t.train"
UNIT = "%"
LAYER = "CUDA kernels ops/csrc"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
WORKLOADS = ["nerfh_w256.train"]


def read(run):
    return readers.roofline_pct(run, "fine_raw_t")
