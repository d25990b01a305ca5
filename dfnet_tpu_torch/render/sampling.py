"""Ray sampling: stratified coarse samples and inverse-CDF hierarchical
(importance) resampling (port of dfnet_tpu/render/sampling.py), with the
blended and culled draws of the kernel schedules, and the two primitives
every NeRF-W composite shares: the 1e2-terminal deltas and the
transmittance product. This is the render layer's leaf: it imports only
torch, and the kernel layer (ops/) may import it.

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


def sample_pdf_blend(bins, weights, n_total: int, lam: float):
    """One-pass inverse-CDF draw of n_total SORTED samples from
    (1-lam)*pdf(weights over bins) + lam*uniform(bins[0], bins[-1]).
    bins: (N, M+1) sorted; weights: (N, M)."""
    weights = weights.detach() + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    span = bins[..., -1:] - bins[..., :1]
    cdf_u = (bins - bins[..., :1]) / torch.clamp(span, min=1e-10)
    cdf = (1.0 - lam) * cdf + lam * cdf_u
    u = torch.linspace(0.0, 1.0, n_total, device=bins.device)
    u = u.expand(cdf.shape[:-1] + (n_total,))
    return invert_cdf(cdf, bins, u, cdf[..., :1], bins[..., :1]).detach()


def sample_pdf_culled(bins, weights, n_total: int, lam: float, q: float,
                      gen: Optional[torch.Generator] = None):
    """Empty-space-culled blended-CDF sampling: per ray, restrict both
    mixture components to [z_lo, z_hi], the [q, 1-q] quantile range of the
    placement-weights CDF padded by one bin, then draw n_total SORTED
    samples from (1-lam)*pdf(restricted weights) + lam*uniform(z_lo, z_hi).
    The truncated mass is <= 2q, which bounds the composite rgb error.
    gen=None is the test-time (deterministic linspace) draw; with a
    generator the draw is stratified (train time).
    bins: (N, M) sorted; weights: (N, M-1)."""
    weights = weights.detach() + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)  # (N, M)

    # filled on the device: a tensor made from a host list would copy from
    # pageable memory, which makes the host wait for the device every step
    uq = torch.empty(cdf.shape[:-1] + (2,), dtype=torch.float32, device=bins.device)
    uq[..., 0] = q
    uq[..., 1] = 1.0 - q
    zq = invert_cdf(cdf, bins, uq, cdf[..., :1], bins[..., :1])  # (N, 2)

    pad = (bins[..., -1:] - bins[..., :1]) / (bins.shape[-1] - 1)
    z_lo = torch.maximum(zq[..., 0:1] - pad, bins[..., :1])
    z_hi = torch.minimum(zq[..., 1:2] + pad, bins[..., -1:])
    z_hi = torch.maximum(z_hi, z_lo + 1e-4)

    inside = (bins[..., 1:] >= z_lo) & (bins[..., :-1] <= z_hi)
    wm = torch.where(inside, weights, torch.zeros_like(weights))
    pdf_m = wm / torch.clamp(torch.sum(wm, -1, keepdim=True), min=1e-10)
    cdf_w = torch.cumsum(pdf_m, -1)
    cdf_w = torch.cat([torch.zeros_like(cdf_w[..., :1]), cdf_w], -1)
    cdf_u = torch.clamp((bins - z_lo) / (z_hi - z_lo), 0.0, 1.0)
    cdf_mix = (1.0 - lam) * cdf_w + lam * cdf_u

    # scale u per ray by the flat top value of the mixture CDF so the last
    # sample lands just inside z_hi, not on the far plane
    if gen is None:
        u = torch.linspace(0.0, 1.0, n_total, device=bins.device) * (1.0 - 1e-6)
        u = u.expand(cdf_mix.shape[:-1] + (n_total,))
    else:
        xi = uniform(cdf_mix.shape[:-1] + (n_total,), gen, bins.device)
        u = (torch.arange(n_total, dtype=torch.float32, device=bins.device)
             + xi) / n_total * (1.0 - 1e-6)
    u = u * cdf_mix[..., -1:]
    return invert_cdf(cdf_mix, bins, u, cdf_mix[..., :1],
                      bins[..., :1]).detach()


def nerfw_deltas(z):
    """(N, S) intervals between the samples z (N, S), the last one 1e2
    long: NeRF-W's terminal delta, not scaled by |rays_d|."""
    d = z[..., 1:] - z[..., :-1]
    return torch.cat([d, 1e2 * torch.ones_like(d[..., :1])], -1)


def transmittance(alphas):
    """[1, 1-a0, (1-a0)(1-a1), ...] along the last (sample) axis: the
    transmittance before each sample."""
    shifted = torch.cat([torch.ones_like(alphas[..., :1]),
                         1.0 - alphas[..., :-1]], -1)
    return torch.cumprod(shifted, -1)
