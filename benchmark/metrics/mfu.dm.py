"""The whole stage-3 step's share of the card's peak: the render's float32
MLP sweeps at the float32 peak and DFNet's bf16 convs at the bf16 dense
peak, over the traced window."""

from benchmark import readers

NAME = "mfu.dm"
UNIT = "%"
LAYER = "training/dm_trainer.py DMTrainer.train_step"
SOURCE = "host_clock"
MOVES = "dm_images_per_s"
WORKLOADS = ["nerfh_w128.dm"]


def read(run):
    return readers.mfu_pct(run)
