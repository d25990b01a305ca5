"""The plain reference of the original NeRF (Mildenhall et al., ECCV 2020,
arXiv:2003.08934): float32 PyTorch, written from the paper and independent
of the program (it imports nothing of dfnet_tpu_torch, nor JAX, nor the
JAX package; the matmul precisions, the positional encoding, the
inverse-CDF draw and Adam are reference_nerfh.py's). TF32 is off for
matmuls and cuDNN in `loss_and_grads` and `render_view`.

- `nerf`: the MLP of the paper's appendix A (Fig. 7): D ReLU layers of W
  on PE(xyz); the encoded input concatenated to the activation of layer
  s for each s in `skips` (the 5th layer's at [4]); the density head on
  the trunk; a W-wide feature layer with no activation; [feature |
  PE(dir)] through one W/2-wide ReLU layer to rgb. Raw outputs.
- `raw2outputs`: the quadrature of the paper's Eq. 3: ReLU density,
  sigmoid colour, each interval's length along the ray, white background.
- `loss_and_grads`: one stage-1 batch, coarse and fine nets with the fine
  net over the sorted union of the stratified and the importance samples
  (§5.2), the loss c_l + f_l and its gradients by autograd, computed in
  blocks of rays (the loss is a mean over rays, so the blocks' weighted
  sums are the batch's).
- `render_view`: the test-time render of a view, in blocks of rays.

Departures from the paper, each as the program and DFNet's code have it:
- PE(p) includes p itself (3 + 6L features), as nerf-pytorch's does.
- Each loss term is half the mean squared error over rays and channels
  (DFNet's nerfw_loss), where the paper sums squared errors over rays.
- The terminal interval is 1e10 and 1e-10 joins each factor of the
  transmittance product (nerf-pytorch's raw2outputs); importance weights
  are the coarse weights of the inner samples plus 1e-5.
- Adam's eps is 1e-8 (the program's ADAM_HYPER), where the paper's is 1e-7.
- The learning rate decays by epochs of the program's schedule
  (exp_decayed_lr), not by steps; the checked steps share one rate.
- Every matmul product goes through reference_nerfh.Matmul, so the fp8
  control can put its operands one precision step below the kernels'.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from benchmark.reference_nerfh import Matmul, dense, embed, float32_matmuls, sample_pdf


def nerf(p: Dict, x0: torch.Tensor, dir_emb: torch.Tensor, D: int, skips,
         mm: Matmul):
    """(rgb raw (N, S, 3), sigma raw (N, S)) of one net at encoded points
    x0 (N, S, 3 + 6L) seen along directions encoded as dir_emb (N, 3 + 6L')."""
    h = x0
    for i in range(D):
        h = torch.relu(dense(p[f"pts_{i}"], h, mm))
        if i in skips:
            h = torch.cat([x0, h], -1)
    sigma = dense(p["alpha"], h, mm)[..., 0]
    feature = dense(p["feature"], h, mm)
    d = dir_emb[:, None, :].expand(-1, h.shape[1], -1)
    hv = torch.relu(dense(p["views_0"], torch.cat([feature, d], -1), mm))
    return dense(p["rgb"], hv, mm), sigma


def raw2outputs(rgb_raw, sigma_raw, z, rays_d, white_bkgd: bool) -> Dict:
    """rgb (N, 3), disp, acc, depth and weights (N, S) of raw outputs at
    sorted samples z (N, S)."""
    dists = z[:, 1:] - z[:, :-1]
    dists = torch.cat([dists, torch.full_like(dists[:, :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-torch.relu(sigma_raw) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -1),
                          -1)[:, :-1]
    weights = alpha * trans
    rgb = (weights[..., None] * torch.sigmoid(rgb_raw)).sum(-2)
    acc = weights.sum(-1)
    depth = (weights * z).sum(-1)
    disp = 1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-10), min=1e-10)
    if white_bkgd:
        rgb = rgb + (1.0 - acc[:, None])
    return {"rgb": rgb, "disp": disp, "acc": acc, "depth": depth, "weights": weights}


def stratified(n: int, S: int, near: float, far: float, device,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, S) samples evenly spaced in depth; with u (n, S) in [0, 1),
    each drawn uniformly inside its interval between midpoints (Eq. 2)."""
    t = torch.linspace(0.0, 1.0, S, device=device)
    z = (near * (1.0 - t) + far * t).expand(n, S)
    if u is None:
        return z
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    lower = torch.cat([z[:, :1], mids], -1)
    upper = torch.cat([mids, z[:, -1:]], -1)
    return lower + (upper - lower) * u


def render_rays(params: Dict, c: Dict, rays_o, rays_d, mm: Matmul,
                u_strat: Optional[torch.Tensor] = None,
                u_imp: Optional[torch.Tensor] = None) -> Dict:
    """The coarse and fine passes over a ray batch: the fine outputs, and
    the coarse rgb as rgb0. Without draws, the test-time samples (evenly
    spaced, importance samples at evenly spaced CDF values)."""
    n, dev = rays_o.shape[0], rays_o.device
    S, I, white = c["N_samples"], c["N_importance"], c["white_bkgd"]
    z = stratified(n, S, c["near"], c["far"], dev, u_strat)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    dir_emb = embed(viewdirs, c["multires_views"])
    skips = c["skips"]

    def net(name, zs, D):
        pts = rays_o[:, None] + rays_d[:, None] * zs[..., None]
        rgb_raw, sigma_raw = nerf(params[name], embed(pts, c["multires"]), dir_emb, D,
                                  skips, mm)
        return raw2outputs(rgb_raw, sigma_raw, zs, rays_d, white)

    coarse = net("coarse", z, c["netdepth"])
    z_imp = sample_pdf(0.5 * (z[:, 1:] + z[:, :-1]), coarse["weights"][:, 1:-1], I, u_imp)
    z_all = torch.sort(torch.cat([z, z_imp], -1), -1).values.detach()
    out = net("fine", z_all, c["netdepth_fine"])
    out["rgb0"] = coarse["rgb"]
    return out


def loss_and_grads(leaves: List[torch.Tensor], params: Dict, c: Dict, rays_o, rays_d,
                   target, u_strat, u_imp, mm: Matmul, block: int = 1024):
    """(loss, [gradient of each of `leaves`], the fine rgb (N, 3)) of one
    batch: c_l + f_l, half the mean squared error of the coarse and of the
    fine rgb; `params` is the tree of the leaves. Blocks of `block` rays
    each add their share. TF32 is off throughout."""
    with float32_matmuls():
        return _loss_and_grads(leaves, params, c, rays_o, rays_d, target, u_strat, u_imp,
                               mm, block)


def _loss_and_grads(leaves, params, c, rays_o, rays_d, target, u_strat, u_imp, mm, block):
    n = rays_o.shape[0]
    grads = [torch.zeros_like(t) for t in leaves]
    total, rgb = 0.0, []
    for lo in range(0, n, block):
        sl = slice(lo, min(lo + block, n))
        out = render_rays(params, c, rays_o[sl], rays_d[sl], mm, u_strat[sl], u_imp[sl])
        loss = (0.5 * torch.mean((out["rgb0"] - target[sl]) ** 2)
                + 0.5 * torch.mean((out["rgb"] - target[sl]) ** 2))
        share = (sl.stop - sl.start) / n
        for g, d in zip(grads, torch.autograd.grad(loss * share, leaves, allow_unused=True)):
            if d is not None:
                g.add_(d)
        total += float(loss.detach()) * share
        rgb.append(out["rgb"].detach())
    return total, grads, torch.cat(rgb)


@torch.no_grad()
def render_view(params: Dict, c: Dict, rays_o, rays_d, mm: Matmul,
                block: int = 4096) -> Dict:
    """rgb, disp and acc of a view's rays at test time, in blocks of
    `block` rays, TF32 off."""
    with float32_matmuls():
        outs = [render_rays(params, c, o, d, mm)
                for o, d in zip(rays_o.split(block), rays_d.split(block))]
    return {k: torch.cat([o[k] for o in outs]) for k in ("rgb", "disp", "acc")}
