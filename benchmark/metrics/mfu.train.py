"""The whole train step's share of the card's peak: the kernels' sweeps
forward and backward at the bf16 dense peak and the proposal net's
float32 forward and backward at the float32 peak, over the traced window."""

from benchmark import readers

NAME = "mfu.train"
UNIT = "%"
LAYER = "training/nerf_trainer.py NeRFTrainer.train_step"
SOURCE = "host_clock"
MOVES = "train_rays_per_s"
WORKLOADS = ["nerfh_w256.train"]


def read(run):
    return readers.mfu_pct(run)
