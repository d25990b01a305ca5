"""Host waits for the device a view of the render cells: stream, device and
event synchronisations (blocking copies end in one) inside the view's root
region (benchmark/spans.py)."""

from benchmark import spans

NAME = "syncs.render"
UNIT = "syncs"
LAYER = "render/fast.py render_image_fast"
SOURCE = "program_span"
MOVES = "render_rays_per_s"
WORKLOADS = ["nerfh_w128.render_exact", "nerfh_w128.render_culled"]


def read(run):
    return spans.syncs(run, "render")
