"""Sinusoidal positional encoding (port of dfnet_tpu/models/embedder.py).

Feature order per input: [identity, sin(f0·x), cos(f0·x), sin(f1·x),
cos(f1·x), ...] with log-spaced frequencies 2^0..2^max, each sin/cos
block over all input channels. The windowed (coarse-to-fine) variant
(--reduce_embedding 2) takes an epoch, which the plain renderer
(render/volume.py) and the stage-1 loss hand it; the kernel paths never
window (render/fast.py::kernels_serve refuses a windowed embedder, so
such a model takes the plain renderer).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Embedder:
    input_dims: int
    num_freqs: int
    max_freq_log2: float
    include_input: bool = True
    log_sampling: bool = True
    windowed: bool = False           # DNeRF/Nerfie coarse-to-fine annealing
    epoch_to_max_freq: int = -1      # N in Nerfie Eq.(8)

    @property
    def out_dim(self) -> int:
        d = self.input_dims if self.include_input else 0
        return d + 2 * self.num_freqs * self.input_dims

    @property
    def freq_bands(self) -> np.ndarray:
        if self.num_freqs == 0:
            return np.zeros((0,), np.float32)
        if self.log_sampling:
            return (2.0 ** np.linspace(0.0, self.max_freq_log2, self.num_freqs)).astype(np.float32)
        return np.linspace(2.0 ** 0.0, 2.0 ** self.max_freq_log2, self.num_freqs).astype(np.float32)

    def __call__(self, x: torch.Tensor, epoch=None) -> torch.Tensor:
        """x: (..., input_dims) -> (..., out_dim)."""
        if self.num_freqs == 0 or self.max_freq_log2 == 0:
            return x
        freqs = torch.as_tensor(self.freq_bands, device=x.device)
        xb = x[..., None, :] * freqs[:, None]          # (..., F, D)
        sin, cos = torch.sin(xb), torch.cos(xb)
        if self.windowed and epoch is not None:
            w = self._window(float(epoch)).to(x.device)
            sin = sin * w[:, None]
            cos = cos * w[:, None]
        enc = torch.stack([sin, cos], -2)              # (..., F, 2, D)
        enc = enc.reshape(*x.shape[:-1], 2 * self.num_freqs * self.input_dims)
        if self.include_input:
            return torch.cat([x, enc], -1)
        return enc

    def _window(self, epoch: float) -> torch.Tensor:
        """Nerfie Eq.(8): w_j = (1 - cos(pi·clamp(alpha - j, 0, 1)))/2 with
        alpha = num_freqs · epoch / N."""
        alpha = self.num_freqs * epoch / self.epoch_to_max_freq
        j = torch.arange(self.num_freqs, dtype=torch.float32)
        t = torch.clamp(alpha - j, 0.0, 1.0)
        return (1.0 - torch.cos(math.pi * t)) / 2.0


def get_embedder(multires: int, i_embed: int = 0, reduce_mode: int = -1,
                 epoch_to_max_freq: int = -1, input_dims: int = 3) -> Embedder:
    """Build an embedder from the reference's flag semantics:
    i_embed=-1 -> identity; reduce_mode 0 -> half the frequencies;
    1 -> no frequencies; 2 -> DNeRF windowed; else default."""
    if i_embed == -1:
        return Embedder(input_dims, 0, 0.0)
    if reduce_mode == 0:
        return Embedder(input_dims, multires // 2, (multires - 1) // 2)
    if reduce_mode == 1:
        return Embedder(input_dims, 0, 0.0)
    if reduce_mode == 2:
        return Embedder(input_dims, multires, multires - 1,
                        windowed=True, epoch_to_max_freq=epoch_to_max_freq)
    return Embedder(input_dims, multires, multires - 1)
