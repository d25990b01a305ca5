"""Host waits for the device a step of the stage-1 train cell: stream, device
and event synchronisations (blocking copies end in one) inside the step's
root region (benchmark/spans.py)."""

from benchmark import spans

NAME = "syncs.train"
UNIT = "syncs"
LAYER = "training/nerf_trainer.py NeRFTrainer.train_step"
SOURCE = "program_span"
MOVES = "train_rays_per_s"
WORKLOADS = ["nerfh_w256.train"]


def read(run):
    return spans.syncs(run, "train")
