"""fine_raw_t (ops/csrc/fine_raw.cu) in the render cells: the bound of its
launches over their device time."""

from benchmark import readers

NAME = "roofline_pct.fine_raw_t.render"
UNIT = "%"
LAYER = "CUDA kernels ops/csrc"
SOURCE = "device_trace"
MOVES = "render_rays_per_s"
WORKLOADS = ["nerfh_w128.render_exact", "nerfh_w128.render_culled"]


def read(run):
    return readers.roofline_pct(run, "fine_raw_t")
