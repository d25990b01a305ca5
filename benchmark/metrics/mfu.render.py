"""The whole render's share of the card's peak: the placement and fine
sweeps' matmul operations on the view's real rays at the samples the
schedule evaluates, at the bf16 dense peak, over the traced window."""

from benchmark import readers

NAME = "mfu.render"
UNIT = "%"
LAYER = "render/fast.py render_image_fast"
SOURCE = "host_clock"
MOVES = "render_rays_per_s"
WORKLOADS = ["nerfh_w128.render_exact", "nerfh_w128.render_culled"]


def read(run):
    return readers.mfu_pct(run)
