"""The share of the traced window of the stage-3 cell in which no kernel,
copy or set ran on the card (torch.profiler)."""

from benchmark import readers

NAME = "device_idle_pct.dm"
UNIT = "%"
LAYER = "H100 device"
SOURCE = "device_trace"
MOVES = "dm_images_per_s"
WORKLOADS = ["nerfh_w128.dm"]


def read(run):
    return readers.idle_pct(run)
