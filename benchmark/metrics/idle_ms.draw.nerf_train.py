"""The device's idle time a step of the original NeRF's stage-1 train cell, in
ms, under draw_batch, the step's rays and pixels (benchmark/spans.py)."""

from benchmark import spans

NAME = "idle_ms.draw.nerf_train"
UNIT = "ms"
LAYER = "training/nerf_trainer.py NeRFTrainer.train_step"
SOURCE = "program_span"
MOVES = "train_rays_per_s"
WORKLOADS = ["nerf_vanilla.train"]


def read(run):
    return spans.idle_ms(run, "train", "draw")
