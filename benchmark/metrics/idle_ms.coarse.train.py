"""The device's idle time a step of the stage-1 train cell, in ms, under
per_ray_row_static, the coarse RawSweep (fine_raw_t on the static pack) and
the sigma noise (benchmark/spans.py)."""

from benchmark import spans

NAME = "idle_ms.coarse.train"
UNIT = "ms"
LAYER = "training/nerf_trainer.py NeRFTrainer.train_step"
SOURCE = "program_span"
MOVES = "train_rays_per_s"
WORKLOADS = ["nerfh_w256.train"]


def read(run):
    return spans.idle_ms(run, "train", "coarse")
