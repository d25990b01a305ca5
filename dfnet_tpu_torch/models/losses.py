"""NeRF-W training losses (Eq. 13 of the NeRF-W paper), the proposal
sampler's bound loss and image helpers (port of
dfnet_tpu/models/losses.py)."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def img2mse(x, y):
    return torch.mean((x - y) ** 2)


def mse2psnr(mse):
    return -10.0 * torch.log(mse) / math.log(10.0)


def to8b(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


def nerfw_loss(results: Dict, target, coef: float = 1.0,
               lambda_u: float = 0.01) -> Dict:
    """c_l: coarse MSE/2; f_l: fine MSE attenuated by beta^2; b_l:
    3+log(beta); s_l: lambda_u * mean(transient sigma). Keys follow the
    reference."""
    ret = {"c_l": 0.5 * torch.mean((results["rgb0"] - target) ** 2)}
    if results.get("rgb") is not None:
        if results.get("beta") is None:
            ret["f_l"] = 0.5 * torch.mean((results["rgb"] - target) ** 2)
        else:
            beta = results["beta"][:, None]
            ret["f_l"] = torch.mean((results["rgb"] - target) ** 2 / (2.0 * beta ** 2))
            ret["b_l"] = 3.0 + torch.mean(torch.log(results["beta"]))
            ret["s_l"] = lambda_u * torch.mean(results["transient_sigmas"])
    return {k: coef * v for k, v in ret.items()}


def color_loss(results: Dict, target, coef: float = 1.0):
    loss = torch.mean((results["rgb0"] - target) ** 2)
    if "rgb" in results:
        loss = loss + torch.mean((results["rgb"] - target) ** 2)
    return coef * loss


def proposal_bound_loss(w_prop, z_vals, w_fine, z_all):
    """Interlevel bound loss of the proposal sampler (mip-NeRF 360 Eq. 13
    on the shared uniform coarse grid): the proposal's mass in each coarse
    interval must upper-bound the fine mass landing there. The fine
    weights and samples carry no gradient, so only the proposal learns.
    w_prop: (N, S) at z_vals (N, S); w_fine: (N, Sf) at z_all (N, Sf)."""
    lower = z_vals
    upper = torch.cat([z_vals[:, 1:], torch.full_like(z_vals[:, :1], 1e10)], -1)
    z = z_all.detach()
    wf = w_fine.detach()
    inside = (z[:, None, :] >= lower[..., None]) & (z[:, None, :] < upper[..., None])
    w_in = torch.where(inside, wf[:, None, :], torch.zeros_like(wf[:, None, :])).sum(-1)
    excess = torch.relu(w_in - w_prop)
    return torch.mean(excess ** 2 / (w_prop + 1e-2))
