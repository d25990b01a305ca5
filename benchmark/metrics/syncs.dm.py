"""Host waits for the device a step of the stage-3 cell: stream, device and
event synchronisations (blocking copies end in one) inside the step's root
region (benchmark/spans.py)."""

from benchmark import spans

NAME = "syncs.dm"
UNIT = "syncs"
LAYER = "training/dm_trainer.py DMTrainer.train_step"
SOURCE = "program_span"
MOVES = "dm_images_per_s"
WORKLOADS = ["nerfh_w128.dm"]


def read(run):
    return spans.syncs(run, "dm")
