"""Training callbacks (port of dfnet_tpu/training/callbacks.py):
EarlyStopping, which saves the best checkpoint (val_on_psnr maximises;
`checkpoint.npz` or `checkpoint-{epoch:04d}-{val:.4f}.npz`), and
ReduceLROnPlateau as the reference configures torch's (mode=min,
factor=0.95, relative threshold 1e-4), stepped on the host once an epoch.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional

import numpy as np

from dfnet_tpu_torch.training.checkpoints import save_pytree


class EarlyStopping:
    def __init__(self, out_folder: str, patience: int = 50, verbose: bool = False,
                 delta: float = 0.0, val_on_psnr: bool = False):
        self.patience = patience
        self.verbose = verbose
        self.delta = delta
        self.val_on_psnr = val_on_psnr
        self.counter = 0
        self.best_score: Optional[float] = None
        self.early_stop = False
        self.val_loss_min = np.inf
        self.out_folder = out_folder
        os.makedirs(out_folder, exist_ok=True)

    def __call__(self, val_loss: float, params, epoch: int = -1,
                 save_multiple: bool = False, save_all: bool = False,
                 val_psnr: Optional[float] = None):
        metric = val_psnr if self.val_on_psnr else val_loss
        score = metric if self.val_on_psnr else -val_loss
        if self.best_score is None:
            self.best_score = score
            self.save_checkpoint(metric, params, epoch, save_multiple)
        elif score < self.best_score + self.delta:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
            if save_all:
                self.save_checkpoint(metric, params, epoch, save_multiple=True,
                                     update_best=False)
        else:
            self.best_score = score
            self.save_checkpoint(metric, params, epoch, save_multiple)
            self.counter = 0

    def save_checkpoint(self, val: float, params, epoch: int,
                        save_multiple: bool = False, update_best: bool = True):
        path = osp.join(self.out_folder, "checkpoint.npz")
        if save_multiple:
            path = osp.join(self.out_folder,
                            f"checkpoint-{epoch:04d}-{val:.4f}.npz")
        save_pytree(path, params, epoch=epoch)
        self.last_path = path
        if update_best:
            self.val_loss_min = val

    def is_best_model(self) -> bool:
        return self.counter == 0


class ReduceLROnPlateau:
    def __init__(self, lr: float, factor: float = 0.95, patience: int = 50,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = np.inf
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr
