"""Ray sampling: stratified coarse samples and inverse-CDF hierarchical
(importance) resampling (port of dfnet_tpu/render/sampling.py).

Random draws take an explicit `torch.Generator` that lives on the device
of the tensors they are drawn for (`torch.Generator(device=...)`), or a
RowShard of one: a rank of a data mesh then draws what one device would,
and keeps its rows."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch


@dataclass(frozen=True)
class RowShard:
    """A generator seen from a rank that holds rows [lo, hi) of a batch of
    `total` rows: every draw is taken at the batch's shape (leading dim
    `total`) and cut to those rows, so the ranks consume the generator as
    one device does and a mesh's random tensors are one device's."""
    gen: torch.Generator
    lo: int
    hi: int
    total: int

    @property
    def device(self) -> torch.device:
        return self.gen.device


def _check_gen(gen: Union[torch.Generator, RowShard], device) -> None:
    if gen.device.type != torch.device(device).type:
        raise ValueError(f"a generator on {gen.device} cannot draw for tensors on "
                         f"{device}: make it with torch.Generator(device=...)")


def _draw(fn, shape, gen: Union[torch.Generator, RowShard], device) -> torch.Tensor:
    _check_gen(gen, device)
    if not isinstance(gen, RowShard):
        return fn(shape, generator=gen, device=device)
    if shape[0] != gen.hi - gen.lo:
        raise ValueError(f"a draw of {shape[0]} rows from the rows [{gen.lo}, {gen.hi}) "
                         f"of a RowShard")
    return fn((gen.total,) + tuple(shape[1:]), generator=gen.gen,
              device=device)[gen.lo:gen.hi]


def uniform(shape, gen: Union[torch.Generator, RowShard], device) -> torch.Tensor:
    """U[0, 1) float32 draws from `gen`, which must be on `device`."""
    return _draw(torch.rand, shape, gen, device)


def gaussian(shape, gen: Union[torch.Generator, RowShard], device) -> torch.Tensor:
    """N(0, 1) float32 draws from `gen`, which must be on `device`."""
    return _draw(torch.randn, shape, gen, device)


def stratified_z_vals(near, far, N_samples: int,
                      gen: Optional[torch.Generator] = None,
                      lindisp: bool = False, perturb: float = 0.0):
    """near/far: (N_rays, 1) -> z_vals (N_rays, N_samples). Linear in
    depth (or disparity); with perturb>0 and a generator, uniform jitter
    within each inter-sample interval."""
    t = torch.linspace(0.0, 1.0, N_samples, device=near.device)
    if lindisp:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        z = near * (1.0 - t) + far * t
    if perturb > 0.0 and gen is not None:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], -1)
        lower = torch.cat([z[..., :1], mids], -1)
        u = uniform(z.shape, gen, z.device)
        z = lower + (upper - lower) * u
    return z


def invert_cdf(cdf: torch.Tensor, bins: torch.Tensor, u: torch.Tensor,
               cdf_lo: torch.Tensor, bins_lo: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear inverse of a sorted per-ray CDF.

    cdf, bins: (N, M) nondecreasing along the last axis; u: (N, K).
    `below` is the last k with cdf[k] <= u and `above` the first k with
    cdf[k] > u (the last entry when there is none); where no cdf[k] <= u,
    `below` takes (cdf_lo, bins_lo). Same values as the JAX package's
    masked-reduction form, since both arrays are sorted."""
    M = cdf.shape[-1]
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = (idx - 1).clamp(min=0)
    above = idx.clamp(max=M - 1)
    cdf_b = torch.gather(cdf, -1, below)
    bins_b = torch.gather(bins, -1, below)
    none_below = idx == 0
    cdf_b = torch.where(none_below, cdf_lo.expand_as(cdf_b), cdf_b)
    bins_b = torch.where(none_below, bins_lo.expand_as(bins_b), bins_b)
    cdf_a = torch.gather(cdf, -1, above)
    bins_a = torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def sample_pdf(bins, weights, N_importance: int,
               gen: Optional[torch.Generator] = None, det: bool = False):
    """Inverse-CDF sampling of N_importance points from the piecewise-
    constant pdf over `bins` (N, M+1) with weights (N, M). Weights and
    samples carry no gradient, as in the reference."""
    weights = weights.detach() + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)  # (N, M+1)
    if det or gen is None:
        u = torch.linspace(0.0, 1.0, N_importance, device=cdf.device)
        u = u.expand(cdf.shape[:-1] + (N_importance,))
    else:
        u = uniform(cdf.shape[:-1] + (N_importance,), gen, cdf.device)
    return invert_cdf(cdf, bins, u, cdf[..., :1], bins[..., :1]).detach()
