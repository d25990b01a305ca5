"""Kernel launches a step of the stage-3 cell: the host's cudaLaunch*/
cuLaunch* calls inside the step's root region (benchmark/spans.py)."""

from benchmark import spans

NAME = "launches.dm"
UNIT = "launches"
LAYER = "training/dm_trainer.py DMTrainer.train_step"
SOURCE = "program_span"
MOVES = "dm_images_per_s"
WORKLOADS = ["nerfh_w128.dm"]


def read(run):
    return spans.launches(run, "dm")
