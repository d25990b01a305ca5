"""The whole step's share of the card's peak in the original NeRF's stage-1 train cell:
both nets' sweeps (fine_raw_t and raw_bwd_t on the static packs, at 64 and at
the 192-sample union) at the bf16 dense peak, over the traced window."""

from benchmark import readers

NAME = "mfu.nerf_train"
UNIT = "%"
LAYER = "training/nerf_trainer.py NeRFTrainer.train_step"
SOURCE = "host_clock"
MOVES = "train_rays_per_s"
WORKLOADS = ["nerf_vanilla.train"]


def read(run):
    return readers.mfu_pct(run)
