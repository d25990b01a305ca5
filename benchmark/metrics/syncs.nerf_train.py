"""Host waits for the device a step of the original NeRF's stage-1 train cell:
stream, device and event synchronisations inside the step's root region
(benchmark/spans.py)."""

from benchmark import spans

NAME = "syncs.nerf_train"
UNIT = "syncs"
LAYER = "training/nerf_trainer.py NeRFTrainer.train_step"
SOURCE = "program_span"
MOVES = "train_rays_per_s"
WORKLOADS = ["nerf_vanilla.train"]


def read(run):
    return spans.syncs(run, "train")
