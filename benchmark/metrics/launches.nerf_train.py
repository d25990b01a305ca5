"""Kernel launches a step of the original NeRF's stage-1 train cell: the host's
cudaLaunch*/cuLaunch* calls inside the step's root region (benchmark/spans.py)."""

from benchmark import spans

NAME = "launches.nerf_train"
UNIT = "launches"
LAYER = "training/nerf_trainer.py NeRFTrainer.train_step"
SOURCE = "program_span"
MOVES = "train_rays_per_s"
WORKLOADS = ["nerf_vanilla.train"]


def read(run):
    return spans.launches(run, "train")
