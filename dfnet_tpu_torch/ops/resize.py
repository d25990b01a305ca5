"""Image resizes with the reference's torch semantics (port of
dfnet_tpu/ops/resize.py). Layout: (..., H, W, C).

  - resize_bilinear_align_corners: torch.nn.UpsamplingBilinear2d, bilinear
    with align_corners=True (DFNet's feature-map upsampling);
  - resize_bicubic: torch.nn.Upsample(mode='bicubic'), half-pixel centres
    (align_corners=False), the Keys cubic with a=-0.75, taps clamped at the
    border, no antialias (the tinyimg render upsampling).

The JAX package builds both from explicit taps because jax.image.resize
implements neither; here they are torch's own `interpolate` in those
modes, which computes the same taps and weights (held to the JAX versions
at 1e-5 in tests/test_torch_port_frozen.py). Both are differentiable.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn


def _nhwc_interpolate(x: torch.Tensor, out_h: int, out_w: int, **kw) -> torch.Tensor:
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    y = x.reshape((-1, h, w, c)).permute(0, 3, 1, 2)
    y = Fn.interpolate(y, size=(out_h, out_w), **kw)
    return y.permute(0, 2, 3, 1).reshape(lead + (out_h, out_w, c))


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """x: (..., H, W, C) -> (..., out_h, out_w, C), align_corners=True.
    Same size is the identity."""
    if (out_h, out_w) == tuple(x.shape[-3:-1]):
        return x
    return _nhwc_interpolate(x, out_h, out_w, mode="bilinear", align_corners=True)


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """x: (..., H, W, C) -> (..., out_h, out_w, C). torch nn.Upsample
    bicubic, align_corners=False (no antialias)."""
    return _nhwc_interpolate(x, out_h, out_w, mode="bicubic", align_corners=False)
