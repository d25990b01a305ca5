"""The device's idle time a step of the stage-3 cell, in ms, under
match_losses: G's siamese features and the losses (benchmark/spans.py)."""

from benchmark import spans

NAME = "idle_ms.match.dm"
UNIT = "ms"
LAYER = "training/dm_trainer.py DMTrainer.train_step"
SOURCE = "program_span"
MOVES = "dm_images_per_s"
WORKLOADS = ["nerfh_w128.dm"]


def read(run):
    return spans.idle_ms(run, "dm", "match")
