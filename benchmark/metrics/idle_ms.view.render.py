"""The device's idle time a view of the render cells, in ms, under the view's
own time (dfnet.render.view less its phases): chunked_rays, gather_image and
the rest of render_image_fast (benchmark/spans.py)."""

from benchmark import spans

NAME = "idle_ms.view.render"
UNIT = "ms"
LAYER = "render/fast.py render_image_fast"
SOURCE = "program_span"
MOVES = "render_rays_per_s"
WORKLOADS = ["nerfh_w128.render_exact", "nerfh_w128.render_culled"]


def read(run):
    return spans.idle_ms(run, "render", "view")
