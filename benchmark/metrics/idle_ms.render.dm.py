"""The device's idle time a step of the stage-3 cell, in ms, under
DMTrainer.render: FrozenNeRF.render_fn, the plain 60x80 render with autograd
and the bicubic upsample (benchmark/spans.py)."""

from benchmark import spans

NAME = "idle_ms.render.dm"
UNIT = "ms"
LAYER = "training/nerf_renderer.py FrozenNeRF"
SOURCE = "program_span"
MOVES = "dm_images_per_s"
WORKLOADS = ["nerfh_w128.dm"]


def read(run):
    return spans.idle_ms(run, "dm", "render")
