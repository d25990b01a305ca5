"""The share of the traced window of the original NeRF's stage-1 train cell in which no
kernel, copy or set ran on the card (torch.profiler)."""

from benchmark import readers

NAME = "device_idle_pct.nerf_train"
UNIT = "%"
LAYER = "H100 device"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
WORKLOADS = ["nerf_vanilla.train"]


def read(run):
    return readers.idle_pct(run)
