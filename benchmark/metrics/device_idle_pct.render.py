"""The share of the traced window of the render cells in which no kernel,
copy or set ran on the card (torch.profiler)."""

from benchmark import readers

NAME = "device_idle_pct.render"
UNIT = "%"
LAYER = "H100 device"
SOURCE = "device_trace"
MOVES = "render_rays_per_s"
WORKLOADS = ["nerfh_w128.render_exact", "nerfh_w128.render_culled"]


def read(run):
    return readers.idle_pct(run)
