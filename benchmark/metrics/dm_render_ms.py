"""The mean device time of the trainer's own DMTrainer.render calls in the
window (FrozenNeRF.render_fn: the plain 60x80 render with autograd and
the bicubic upsample), by CUDA events around each call."""

NAME = "dm_render_ms"
UNIT = "ms"
LAYER = "training/nerf_renderer.py FrozenNeRF"
SOURCE = "program_span"
MOVES = "dm_images_per_s"
WORKLOADS = ["nerfh_w128.dm"]


def read(run):
    return getattr(run, "render_ms", None) if run.trace is not None else None
