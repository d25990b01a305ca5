"""The device's idle time a step of the stage-1 train cell, in ms, under the
proposal net's sweep, its composite and proposal_bound_loss
(benchmark/spans.py)."""

from benchmark import spans

NAME = "idle_ms.proposal.train"
UNIT = "ms"
LAYER = "training/nerf_trainer.py NeRFTrainer.train_step"
SOURCE = "program_span"
MOVES = "train_rays_per_s"
WORKLOADS = ["nerfh_w256.train"]


def read(run):
    return spans.idle_ms(run, "train", "proposal")
