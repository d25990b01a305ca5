"""Kernel launches a step of the stage-1 train cell: the host's cudaLaunch*/
cuLaunch* calls inside the step's root region (benchmark/spans.py)."""

from benchmark import spans

NAME = "launches.train"
UNIT = "launches"
LAYER = "training/nerf_trainer.py NeRFTrainer.train_step"
SOURCE = "program_span"
MOVES = "train_rays_per_s"
WORKLOADS = ["nerfh_w256.train"]


def read(run):
    return spans.launches(run, "train")
