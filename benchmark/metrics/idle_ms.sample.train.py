"""The device's idle time a step of the stage-1 train cell, in ms, under the
fine draw: sample_pdf (or sample_pdf_culled) and the sort
(benchmark/spans.py)."""

from benchmark import spans

NAME = "idle_ms.sample.train"
UNIT = "ms"
LAYER = "training/nerf_trainer.py NeRFTrainer.train_step"
SOURCE = "program_span"
MOVES = "train_rays_per_s"
WORKLOADS = ["nerfh_w256.train"]


def read(run):
    return spans.idle_ms(run, "train", "sample")
