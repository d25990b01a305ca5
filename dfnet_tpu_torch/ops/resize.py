"""Image resizes with the reference's torch semantics (port of
dfnet_tpu/ops/resize.py). Layout: (..., H, W, C), except
resize_bilinear_nchw, the (..., C, H, W) form of the bilinear one that
DFNet's feature upsample calls.

  - resize_bilinear_align_corners / resize_bilinear_nchw:
    torch.nn.UpsamplingBilinear2d, bilinear with align_corners=True, as
    two dense matmuls with the axes' interpolation matrices, the JAX
    package's own formulation;
  - resize_bicubic: torch.nn.Upsample(mode='bicubic'), half-pixel centres
    (align_corners=False), the Keys cubic with a=-0.75, taps clamped at the
    border, no antialias (the tinyimg render upsampling). The JAX package
    builds it from explicit taps because jax.image.resize lacks it; here it
    is torch's own `interpolate` in that mode, which computes the same taps
    and weights.

Both are held to the JAX versions at 1e-5 in tests/test_torch_port_frozen.py,
and both are differentiable.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as Fn


def _nhwc_interpolate(x: torch.Tensor, out_h: int, out_w: int, **kw) -> torch.Tensor:
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    y = x.reshape((-1, h, w, c)).permute(0, 3, 1, 2)
    y = Fn.interpolate(y, size=(out_h, out_w), **kw)
    return y.permute(0, 2, 3, 1).reshape(lead + (out_h, out_w, c))


@functools.lru_cache(maxsize=32)
def _bilinear_axis_matrix(out_size: int, in_size: int, dtype: torch.dtype,
                          device: torch.device) -> torch.Tensor:
    """(out, in) dense interpolation matrix for align_corners=True, built in
    float32 as the JAX package builds it, then cast to `dtype`."""
    if out_size == 1 or in_size == 1:
        cs = np.zeros(out_size, np.float32)
    else:
        cs = (np.arange(out_size) * (in_size - 1) / (out_size - 1)).astype(np.float32)
    i0 = np.floor(cs).astype(np.int64)
    i1 = np.minimum(i0 + 1, in_size - 1)
    t = cs - i0
    m = np.zeros((out_size, in_size), np.float32)
    np.add.at(m, (np.arange(out_size), i0), 1.0 - t)
    np.add.at(m, (np.arange(out_size), i1), t)
    return torch.tensor(m, device=device).to(dtype)


def resize_bilinear_nchw(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """x: (..., C, H, W) -> (..., C, out_h, out_w), align_corners=True (DFNet's
    feature upsample). Same size is the identity.

    Two dense matmuls with the axes' interpolation matrices, in x's dtype,
    as the JAX package computes it: the backward is two matmuls too, where
    interpolate's backward scatters with atomics (63 ms for 8 x 128
    channels from 15x20 to 240x320 in bf16 on an H100)."""
    h, w = x.shape[-2:]
    if (out_h, out_w) == (h, w):
        return x
    if out_w != w:
        x = torch.matmul(x, _bilinear_axis_matrix(out_w, w, x.dtype, x.device).t())
    if out_h != h:
        x = torch.matmul(_bilinear_axis_matrix(out_h, h, x.dtype, x.device), x)
    return x


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """x: (..., H, W, C) -> (..., out_h, out_w, C), align_corners=True.
    Same size is the identity."""
    return resize_bilinear_nchw(x.movedim(-1, -3), out_h, out_w).movedim(-3, -1)


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """x: (..., H, W, C) -> (..., out_h, out_w, C). torch nn.Upsample
    bicubic, align_corners=False (no antialias)."""
    return _nhwc_interpolate(x, out_h, out_w, mode="bicubic", align_corners=False)
