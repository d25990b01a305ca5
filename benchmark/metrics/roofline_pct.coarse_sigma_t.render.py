"""coarse_sigma_t (ops/csrc/coarse_sigma.cu), the proposal net's placement
sweep, in the render cells: the bound of its launches over their device
time."""

from benchmark import readers

NAME = "roofline_pct.coarse_sigma_t.render"
UNIT = "%"
LAYER = "CUDA kernels ops/csrc"
SOURCE = "device_trace"
MOVES = "render_rays_per_s"
WORKLOADS = ["nerfh_w128.render_exact", "nerfh_w128.render_culled"]


def read(run):
    return readers.roofline_pct(run, "coarse_sigma_t")
