"""The plain reference of the NeRF-H configurations: float32 PyTorch,
written from the method and independent of the program (it imports
nothing of dfnet_tpu_torch, nor JAX, nor the JAX package).

- `render_view`: a test-time view as the kernel render path computes it
  (render/fast.py's schedules): the proposal net's sigma sweep over a
  uniform placement grid, the inverse-CDF fine samples (the exact union of
  placement and importance samples, or the culled draw inside each ray's
  [q, 1-q] CDF interval), the NeRF-W fine net and its test-time composite
  (rgb static + transient, disparity from the static weights).
- `train_loss`: the stage-1 loss of one ray batch as the kernel train step
  computes it (render/fused_train.py and training/nerf_trainer.py): the
  static coarse sweep at jittered samples, importance samples drawn from
  its weights, the NeRF-W fine sweep, the NeRF-W loss and the proposal
  net's interlevel bound loss against the detached fine weights.
- `adam`: torch.optim.Adam's update.

Every MLP product goes through `Matmul`: float32 operands for the
reference (TF32 off, `float32_matmuls`), operands rounded to fp8 e4m3
with a per-tensor scale (`Matmul("fp8")`, the control one step below the
kernels' bf16 operands), or to TF32's 10-bit mantissa (`Matmul("tf32")`,
the control one step below a float32 render).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as Fn

FP8_MAX = 448.0


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest), with the identity
    as its gradient."""
    b = x.detach().float().contiguous().view(torch.int32)
    q = ((b + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (q - x).detach()


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 at a per-tensor scale, with the identity as
    its gradient (the rounding's backward is the straight-through one)."""
    s = x.detach().abs().max().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach()


class Matmul:
    """x @ w with operands in `precision`: "fp32", "tf32" or "fp8"."""

    ROUND = {"fp32": None, "fp8": fp8_round, "tf32": tf32_round}

    def __init__(self, precision: str = "fp32"):
        if precision not in self.ROUND:
            raise ValueError(f"precision {precision!r}")
        self.precision = precision
        self.round = self.ROUND[precision]

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.round is not None:
            x, w = self.round(x), self.round(w)
        return x @ w


@contextlib.contextmanager
def float32_matmuls():
    """Full float32 products inside: TF32 off for matmuls and convolutions."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# ----------------------------------------------------------------- the nets

def embed(x: torch.Tensor, F: int) -> torch.Tensor:
    """NeRF's positional encoding: [x, sin(2^0 x), cos(2^0 x), ...,
    sin(2^(F-1) x), cos(2^(F-1) x)], each sin or cos over all 3 axes."""
    freqs = 2.0 ** torch.linspace(0.0, F - 1, F, device=x.device)
    xb = x[..., None, :] * freqs[:, None]
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], -2)
    return torch.cat([x, enc.reshape(*x.shape[:-1], 6 * F)], -1)


def dense(p: Dict, x: torch.Tensor, mm: Matmul) -> torch.Tensor:
    return mm(x, p["w"]) + p["b"]


def trunk(p: Dict, x0: torch.Tensor, D: int, skips, mm: Matmul) -> torch.Tensor:
    """The xyz trunk: D ReLU layers, [x0 | h] into each skip layer."""
    h, n0 = x0, x0.shape[-1]
    for i in range(D):
        w = p[f"xyz_{i}"]
        if i in skips:
            y = mm(x0, w["w"][:n0]) + mm(h, w["w"][n0:]) + w["b"]
        else:
            y = dense(w, h, mm)
        h = torch.relu(y)
    return h


def sigma_net(p: Dict, x0, D: int, skips, mm: Matmul) -> torch.Tensor:
    """Softplus density (N, S) of a sigma-only net."""
    return Fn.softplus(dense(p["static_sigma"], trunk(p, x0, D, skips, mm), mm))[..., 0]


def static_net(p: Dict, x0, dir_emb, D: int, W: int, skips, mm: Matmul):
    """(rgb (N, S, 3), sigma (N, S)) of the coarse NeRF-W net; dir_emb is
    per ray and multiplies its rows of `dir` once a ray."""
    h = trunk(p, x0, D, skips, mm)
    sigma = Fn.softplus(dense(p["static_sigma"], h, mm))[..., 0]
    wd = p["dir"]["w"]
    d = torch.relu(mm(dense(p["xyz_final"], h, mm), wd[:W])
                   + (mm(dir_emb, wd[W:]) + p["dir"]["b"])[:, None, :])
    return torch.sigmoid(dense(p["static_rgb"], d, mm)), sigma


def fine_net(p: Dict, x0, dir_emb, a_emb, t_emb, D: int, W: int, skips, mm: Matmul):
    """(static rgb, static sigma, transient rgb, transient sigma, beta) of
    the NeRF-W fine net; dir_emb, a_emb and t_emb are per ray."""
    h = trunk(p, x0, D, skips, mm)
    sigma = Fn.softplus(dense(p["static_sigma"], h, mm))[..., 0]
    xf = dense(p["xyz_final"], h, mm)
    wd, wt = p["dir"]["w"], p["trans_0"]["w"]
    per_d = mm(torch.cat([dir_emb, a_emb], -1), wd[W:]) + p["dir"]["b"]
    per_t = mm(t_emb, wt[W:]) + p["trans_0"]["b"]
    d = torch.relu(mm(xf, wd[:W]) + per_d[:, None, :])
    t = torch.relu(mm(xf, wt[:W]) + per_t[:, None, :])
    for i in (1, 2, 3):
        t = torch.relu(dense(p[f"trans_{i}"], t, mm))
    return (torch.sigmoid(dense(p["static_rgb"], d, mm)), sigma,
            torch.sigmoid(dense(p["trans_rgb"], t, mm)),
            Fn.softplus(dense(p["trans_sigma"], t, mm))[..., 0],
            Fn.softplus(dense(p["trans_beta"], t, mm))[..., 0])


def hist_rows(table: torch.Tensor, hist: torch.Tensor, n: int) -> torch.Tensor:
    """The histogram's table rows, flattened, for n rays: (n, bins * dim)."""
    return table[hist.long()].reshape(1, -1).expand(n, -1)


# ----------------------------------------------------------------- sampling

def uniform_z(n: int, S: int, near: float, far: float, device,
              u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, S) samples linear in depth; with u (n, S) in [0, 1), jittered
    uniformly inside each sample's interval between midpoints."""
    t = torch.linspace(0.0, 1.0, S, device=device)
    z = (near * (1.0 - t) + far * t).expand(n, S)
    if u is None:
        return z
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], -1)
    lower = torch.cat([z[:, :1], mids], -1)
    return lower + (upper - lower) * u


def shifted_cumprod(alphas: torch.Tensor) -> torch.Tensor:
    """Transmittance before each sample: [1, 1-a0, (1-a0)(1-a1), ...]."""
    return torch.cumprod(torch.cat([torch.ones_like(alphas[:, :1]),
                                    1.0 - alphas[:, :-1]], -1), -1)


def deltas(z: torch.Tensor) -> torch.Tensor:
    d = z[:, 1:] - z[:, :-1]
    return torch.cat([d, 1e2 * torch.ones_like(d[:, :1])], -1)


def invert_cdf(cdf, bins, u, cdf_lo, bins_lo):
    """Piecewise-linear inverse of sorted per-ray CDFs at u (N, K): between
    the last cdf entry <= u (else (cdf_lo, bins_lo)) and the first > u
    (else the last); a step under 1e-5 counts as 1."""
    M = cdf.shape[-1]
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below, above = (idx - 1).clamp(min=0), idx.clamp(max=M - 1)
    none = idx == 0
    cdf_b = torch.where(none, cdf_lo.expand(u.shape), torch.gather(cdf, -1, below))
    bins_b = torch.where(none, bins_lo.expand(u.shape), torch.gather(bins, -1, below))
    cdf_a, bins_a = torch.gather(cdf, -1, above), torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


def _cdf(weights: torch.Tensor) -> torch.Tensor:
    w = weights.detach() + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    return torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)


def sample_pdf(bins, weights, n: int, u: Optional[torch.Tensor] = None):
    """n inverse-CDF samples a ray of the piecewise-constant pdf of weights
    (N, M) over bins (N, M+1): at u (N, n), or at linspace(0, 1, n)."""
    cdf = _cdf(weights)
    if u is None:
        u = torch.linspace(0.0, 1.0, n, device=bins.device).expand(bins.shape[0], n)
    return invert_cdf(cdf, bins, u, cdf[:, :1], bins[:, :1]).detach()


def sample_pdf_culled(bins, weights, n: int, lam: float, q: float):
    """The culled draw at test time: n sorted samples from (1-lam) * the
    pdf restricted to [z_lo, z_hi] + lam * uniform(z_lo, z_hi), where
    [z_lo, z_hi] is the weights' [q, 1-q] CDF interval widened by one bin."""
    w = weights.detach() + 1e-5
    cdf = _cdf(weights)
    uq = torch.tensor([q, 1.0 - q], device=bins.device).expand(bins.shape[0], 2)
    zq = invert_cdf(cdf, bins, uq, cdf[:, :1], bins[:, :1])
    pad = (bins[:, -1:] - bins[:, :1]) / (bins.shape[-1] - 1)
    z_lo = torch.maximum(zq[:, 0:1] - pad, bins[:, :1])
    z_hi = torch.minimum(zq[:, 1:2] + pad, bins[:, -1:])
    z_hi = torch.maximum(z_hi, z_lo + 1e-4)
    inside = (bins[:, 1:] >= z_lo) & (bins[:, :-1] <= z_hi)
    wm = torch.where(inside, w, torch.zeros_like(w))
    cdf_w = torch.cumsum(wm / wm.sum(-1, keepdim=True).clamp(min=1e-10), -1)
    cdf_w = torch.cat([torch.zeros_like(cdf_w[:, :1]), cdf_w], -1)
    cdf_u = torch.clamp((bins - z_lo) / (z_hi - z_lo), 0.0, 1.0)
    mix = (1.0 - lam) * cdf_w + lam * cdf_u
    u = torch.linspace(0.0, 1.0, n, device=bins.device) * (1.0 - 1e-6)
    u = u.expand(bins.shape[0], n) * mix[:, -1:]
    return invert_cdf(mix, bins, u, mix[:, :1], bins[:, :1]).detach()


# ------------------------------------------------------------------- render

def render_rays(params: Dict, c: Dict, s: Dict, rays_o, rays_d, hist, mm: Matmul) -> Dict:
    """Test-time render of a ray batch: rgb (N, 3), disp (N,), acc (N,).
    c: the configuration's sizes; s: the schedule (`n_place`, `n_fine`,
    `cull_q`: 0 for the exact union; `placement`: "proposal", the kernel
    path's, or "coarse", the plain renderer's)."""
    n, dev = rays_o.shape[0], rays_o.device
    S, I = c["N_samples"], c["N_importance"]
    P = s.get("n_place") or S
    z = uniform_z(n, P, c["near"], c["far"], dev)
    pts = rays_o[:, None] + rays_d[:, None] * z[..., None]
    if s.get("placement", "proposal") == "proposal":
        sig = sigma_net(params["proposal"], embed(pts, c["proposal_multires"]),
                        c["proposal_D"], (), mm)
    else:       # the coarse net's density (the plain renderer's placement)
        sig = sigma_net(params["coarse"], embed(pts, c["multires"]), c["netdepth"],
                        c["skips"], mm)
    alphas = 1.0 - torch.exp(-deltas(z) * sig)
    weights = alphas * shifted_cumprod(alphas)
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    if s.get("cull_q", 0.0) > 0.0:
        z_all = sample_pdf_culled(z_mid, weights[:, 1:-1], s["n_fine"], S / (S + I),
                                  s["cull_q"])
    else:
        z_imp = sample_pdf(z_mid, weights[:, 1:-1], I)
        z_all = torch.sort(torch.cat([z, z_imp], -1), -1).values
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    fp = params["fine"]
    pts = rays_o[:, None] + rays_d[:, None] * z_all[..., None]
    srgb, ssig, trgb, tsig, _ = fine_net(
        fp, embed(pts, c["multires"]), embed(viewdirs, c["multires_views"]),
        hist_rows(params["embedding_a"], hist, n), hist_rows(params["embedding_t"], hist, n),
        c["netdepth_fine"], c["netwidth_fine"], c["skips"], mm)
    dl = deltas(z_all)
    a_s = 1.0 - torch.exp(-dl * ssig)
    a_t = 1.0 - torch.exp(-dl * tsig)
    a = 1.0 - torch.exp(-dl * (ssig + tsig))
    trans = shifted_cumprod(a)
    acc = (a * trans).sum(-1)
    rgb = ((a_s * trans)[..., None] * srgb).sum(-2) + ((a_t * trans)[..., None] * trgb).sum(-2)
    depth = (a_s * shifted_cumprod(a_s) * z_all).sum(-1)
    disp = 1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-10), min=1e-10)
    return {"rgb": rgb, "disp": disp, "acc": acc}


@torch.no_grad()
def render_view(params: Dict, c: Dict, s: Dict, rays_o, rays_d, hist,
                mm: Matmul, block: int = 4096) -> Dict:
    """render_rays over a view's rays in blocks of `block` rays."""
    outs = [render_rays(params, c, s, o, d, hist, mm)
            for o, d in zip(rays_o.split(block), rays_d.split(block))]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


# -------------------------------------------------------------------- train

def train_loss(params: Dict, c: Dict, rays_o, rays_d, target, hist,
               u_strat, u_imp, mm: Matmul) -> torch.Tensor:
    """The stage-1 loss of one batch: jitter u_strat (N, S) and importance
    draws u_imp (N, N_importance) in [0, 1)."""
    n, dev = rays_o.shape[0], rays_o.device
    S, I = c["N_samples"], c["N_importance"]
    W, Wf, skips = c["netwidth"], c["netwidth_fine"], c["skips"]
    z = uniform_z(n, S, c["near"], c["far"], dev, u_strat)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    dir_emb = embed(viewdirs, c["multires_views"])
    pts = rays_o[:, None] + rays_d[:, None] * z[..., None]
    rgb_c, sig_c = static_net(params["coarse"], embed(pts, c["multires"]), dir_emb,
                              c["netdepth"], W, skips, mm)
    a = 1.0 - torch.exp(-deltas(z) * sig_c)
    w_c = a * shifted_cumprod(a)
    rgb0 = (w_c[..., None] * rgb_c).sum(-2)
    z_imp = sample_pdf(0.5 * (z[:, 1:] + z[:, :-1]), w_c[:, 1:-1], I, u_imp)
    z_all = torch.sort(torch.cat([z, z_imp], -1), -1).values.detach()
    pts_f = rays_o[:, None] + rays_d[:, None] * z_all[..., None]
    srgb, ssig, trgb, tsig, tbeta = fine_net(
        params["fine"], embed(pts_f, c["multires"]), dir_emb,
        hist_rows(params["embedding_a"], hist, n), hist_rows(params["embedding_t"], hist, n),
        c["netdepth_fine"], Wf, skips, mm)
    dl = deltas(z_all)
    a_s = 1.0 - torch.exp(-dl * ssig)
    a_t = 1.0 - torch.exp(-dl * tsig)
    a = 1.0 - torch.exp(-dl * (ssig + tsig))
    trans = shifted_cumprod(a)
    w_f = a * trans
    rgb = ((a_s * trans)[..., None] * srgb).sum(-2) + ((a_t * trans)[..., None] * trgb).sum(-2)
    beta = (a_t * trans * tbeta).sum(-1) + c["beta_min"]
    loss = (0.5 * torch.mean((rgb0 - target) ** 2)
            + torch.mean((rgb - target) ** 2 / (2.0 * beta[:, None] ** 2))
            + 3.0 + torch.mean(torch.log(beta))
            + 0.01 * torch.mean(tsig))
    # the proposal net's interlevel bound loss on the coarse grid
    zd = z.detach()
    pts_p = rays_o[:, None] + rays_d[:, None] * zd[..., None]
    sig_p = sigma_net(params["proposal"], embed(pts_p, c["proposal_multires"]),
                      c["proposal_D"], (), mm)
    a_p = 1.0 - torch.exp(-deltas(zd) * sig_p)
    w_p = a_p * shifted_cumprod(a_p)
    upper = torch.cat([zd[:, 1:], torch.full_like(zd[:, :1], 1e10)], -1)
    inside = (z_all[:, None, :] >= zd[..., None]) & (z_all[:, None, :] < upper[..., None])
    wf = w_f.detach()[:, None, :]
    w_in = torch.where(inside, wf, torch.zeros_like(wf)).sum(-1)
    bound = torch.mean(torch.relu(w_in - w_p) ** 2 / (w_p + 1e-2))
    return loss + c["proposal_loss_w"] * bound


def adam(params, grads, state: Dict, lr: float, b1=0.9, b2=0.999, eps=1e-8) -> None:
    """torch.optim.Adam's step on lists of leaves, in place; state holds
    "t", "m" and "v" (lists), made at the first step."""
    if not state:
        state.update(t=0, m=[torch.zeros_like(p) for p in params],
                     v=[torch.zeros_like(p) for p in params])
    state["t"] += 1
    t = state["t"]
    for p, g, m, v in zip(params, grads, state["m"], state["v"]):
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
        p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))
