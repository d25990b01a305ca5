"""The device's idle time a view of the render cells, in ms, under
composite_soa, the composite of the fine sweep's raw rows
(benchmark/spans.py)."""

from benchmark import spans

NAME = "idle_ms.composite.render"
UNIT = "ms"
LAYER = "render/fast.py render_image_fast"
SOURCE = "program_span"
MOVES = "render_rays_per_s"
WORKLOADS = ["nerfh_w128.render_exact", "nerfh_w128.render_culled"]


def read(run):
    return spans.idle_ms(run, "render", "composite")
