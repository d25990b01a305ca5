"""The share of the traced window of the stage-1 train cell in which no
kernel, copy or set ran on the card (torch.profiler)."""

from benchmark import readers

NAME = "device_idle_pct.train"
UNIT = "%"
LAYER = "H100 device"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
WORKLOADS = ["nerfh_w256.train"]


def read(run):
    return readers.idle_pct(run)
