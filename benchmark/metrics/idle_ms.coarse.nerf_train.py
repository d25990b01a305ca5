"""The device's idle time a step of the original NeRF's stage-1 train cell, in
ms, under per_ray_row_vanilla and the coarse RawSweep (fine_raw_t
on the coarse net's static pack, S=64) (benchmark/spans.py)."""

from benchmark import spans

NAME = "idle_ms.coarse.nerf_train"
UNIT = "ms"
LAYER = "training/nerf_trainer.py NeRFTrainer.train_step"
SOURCE = "program_span"
MOVES = "train_rays_per_s"
WORKLOADS = ["nerf_vanilla.train"]


def read(run):
    return spans.idle_ms(run, "train", "coarse")
