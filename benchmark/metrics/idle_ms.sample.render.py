"""The device's idle time a view of the render cells, in ms, under the fine
draw: the exact union's sample_pdf and sort, or sample_pdf_culled
(benchmark/spans.py)."""

from benchmark import spans

NAME = "idle_ms.sample.render"
UNIT = "ms"
LAYER = "render/fast.py render_image_fast"
SOURCE = "program_span"
MOVES = "render_rays_per_s"
WORKLOADS = ["nerfh_w128.render_exact", "nerfh_w128.render_culled"]


def read(run):
    return spans.idle_ms(run, "render", "sample")
