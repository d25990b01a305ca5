"""The device's idle time a step of the stage-3 cell, in ms, under
predict_poses: F's forward, outside the SVD (benchmark/spans.py)."""

from benchmark import spans

NAME = "idle_ms.pose.dm"
UNIT = "ms"
LAYER = "training/dm_trainer.py DMTrainer.train_step"
SOURCE = "program_span"
MOVES = "dm_images_per_s"
WORKLOADS = ["nerfh_w128.dm"]


def read(run):
    return spans.idle_ms(run, "dm", "pose")
