"""Kernel launches a view of the render cells: the host's cudaLaunch*/
cuLaunch* calls inside the view's root region (benchmark/spans.py)."""

from benchmark import spans

NAME = "launches.render"
UNIT = "launches"
LAYER = "render/fast.py render_image_fast"
SOURCE = "program_span"
MOVES = "render_rays_per_s"
WORKLOADS = ["nerfh_w128.render_exact", "nerfh_w128.render_culled"]


def read(run):
    return spans.launches(run, "render")
