"""NeRF-W / NeRF-Hist MLPs on plain param dicts (port of
dfnet_tpu/models/nerfw.py).

Params are nested dicts of {'w': (in, out), 'b': (out,)} tensors with the
JAX package's names and shapes, so checkpoints move between the two
packages unchanged (training/checkpoints.py). `compute_dtype=bfloat16`
rounds matmul operands to bf16 and accumulates in float32, as the JAX
package's `preferred_element_type=float32` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as Fn


@dataclass(frozen=True)
class NeRFWConfig:
    D: int = 8
    W: int = 128
    skips: tuple = (4,)
    in_xyz: int = 63
    in_dir: int = 27
    in_a: int = 50          # appearance embedding dim (fine only)
    in_t: int = 20          # transient embedding dim (fine only)
    encode_appearance: bool = False
    encode_transient: bool = False
    beta_min: float = 0.1
    out_ch: int = 3
    compute_dtype: torch.dtype = torch.float32


def linear_init(gen: torch.Generator, fan_in: int, fan_out: int, device) -> Dict:
    """torch.nn.Linear's default init: uniform(+-1/sqrt(fan_in)) weights
    and bias."""
    bound = 1.0 / fan_in ** 0.5
    w = (torch.rand((fan_in, fan_out), generator=gen) * 2 - 1) * bound
    b = (torch.rand((fan_out,), generator=gen) * 2 - 1) * bound
    return {"w": w.to(device), "b": b.to(device)}


def init_nerfw_params(gen: torch.Generator, cfg: NeRFWConfig, device="cpu") -> Dict:
    """Parameter tree for one (coarse or fine) NeRF-W MLP."""
    p: Dict = {}
    in_a = cfg.in_a if cfg.encode_appearance else 0
    for i in range(cfg.D):
        fan_in = cfg.in_xyz if i == 0 else (cfg.W + cfg.in_xyz if i in cfg.skips else cfg.W)
        p[f"xyz_{i}"] = linear_init(gen, fan_in, cfg.W, device)
    p["xyz_final"] = linear_init(gen, cfg.W, cfg.W, device)
    p["dir"] = linear_init(gen, cfg.W + cfg.in_dir + in_a, cfg.W // 2, device)
    p["static_sigma"] = linear_init(gen, cfg.W, 1, device)
    p["static_rgb"] = linear_init(gen, cfg.W // 2, cfg.out_ch, device)
    if cfg.encode_transient:
        p["trans_0"] = linear_init(gen, cfg.W + cfg.in_t, cfg.W // 2, device)
        for i in (1, 2, 3):
            p[f"trans_{i}"] = linear_init(gen, cfg.W // 2, cfg.W // 2, device)
        p["trans_sigma"] = linear_init(gen, cfg.W // 2, 1, device)
        p["trans_rgb"] = linear_init(gen, cfg.W // 2, cfg.out_ch, device)
        p["trans_beta"] = linear_init(gen, cfg.W // 2, 1, device)
    return p


def init_sigma_mlp(gen: torch.Generator, cfg: NeRFWConfig, device="cpu") -> Dict:
    """Sigma-only MLP params (proposal sampler): xyz trunk + static_sigma."""
    p: Dict = {}
    for i in range(cfg.D):
        fan_in = cfg.in_xyz if i == 0 else (
            cfg.W + cfg.in_xyz if i in cfg.skips else cfg.W)
        p[f"xyz_{i}"] = linear_init(gen, fan_in, cfg.W, device)
    p["static_sigma"] = linear_init(gen, cfg.W, 1, device)
    return p


def init_embeddings(gen: torch.Generator, n_vocab: int, n_a: int = 5,
                    n_tau: int = 2, device="cpu") -> Dict:
    """Appearance/transient embedding tables, N(0,1) like nn.Embedding."""
    return {"a": torch.randn((n_vocab, n_a), generator=gen).to(device),
            "t": torch.randn((n_vocab, n_tau), generator=gen).to(device)}


def mm(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """x @ w with `dt` operands and a float32 result (bf16 operands are
    rounded, then multiplied in float32)."""
    if dt == torch.float32:
        return x.float() @ w.float()
    return x.to(dt).float() @ w.to(dt).float()


def dense(p, x, dt):
    """x @ p["w"] + p["b"] with `dt` operands (mm)."""
    return mm(x, p["w"], dt) + p["b"]


def nerfw_apply_rays(
    params: Dict,
    cfg: NeRFWConfig,
    xyz_emb: torch.Tensor,                   # (N, S, in_xyz) per point
    dir_emb: Optional[torch.Tensor] = None,  # (N, in_dir) per ray
    a_emb: Optional[torch.Tensor] = None,    # (N, in_a) per ray
    t_emb: Optional[torch.Tensor] = None,    # (N, in_t) per ray
    sigma_only: bool = False,
    output_transient: bool = False,
) -> torch.Tensor:
    """Ray-structured apply: per-ray inputs (viewdirs, appearance and
    transient embeddings) multiply their weight rows once per ray,
        [h, d, a] @ W = h @ W_h + (d @ W_d + a @ W_a)[:, None, :].
    Returns (N, S, C): sigma_only C=1 (softplus sigma); output_transient
    C=2*out_ch+3 (rgb, sigma, t-rgb, t-sigma, t-beta); else C=out_ch+1."""
    dt = cfg.compute_dtype
    x0 = xyz_emb
    h = x0
    for i in range(cfg.D):
        if i in cfg.skips:
            w = params[f"xyz_{i}"]["w"]
            y = (mm(x0, w[:cfg.in_xyz], dt) + mm(h, w[cfg.in_xyz:], dt)
                 + params[f"xyz_{i}"]["b"])
        else:
            y = dense(params[f"xyz_{i}"], h, dt)
        h = torch.relu(y)
        if dt != torch.float32:
            h = h.to(dt).float()
    W = cfg.W
    static_sigma = Fn.softplus(dense(params["static_sigma"], h, dt))
    if sigma_only:
        return static_sigma

    xyz_final = dense(params["xyz_final"], h, dt)
    wd = params["dir"]["w"]
    per_ray = mm(dir_emb, wd[W:W + cfg.in_dir], dt)
    if cfg.encode_appearance:
        per_ray = per_ray + mm(a_emb, wd[W + cfg.in_dir:], dt)
    per_ray = per_ray + params["dir"]["b"]

    if not output_transient:
        d = torch.relu(mm(xyz_final, wd[:W], dt) + per_ray[:, None, :])
        rgb = dense(params["static_rgb"], d, dt)
        if cfg.out_ch == 3:
            rgb = torch.sigmoid(rgb)
        return torch.cat([rgb, static_sigma], -1)

    wt = params["trans_0"]["w"]
    t_per_ray = mm(t_emb, wt[W:], dt) + params["trans_0"]["b"]
    d = torch.relu(mm(xyz_final, wd[:W], dt) + per_ray[:, None, :])
    t = torch.relu(mm(xyz_final, wt[:W], dt) + t_per_ray[:, None, :])
    if dt != torch.float32:
        d, t = d.to(dt).float(), t.to(dt).float()
    for i in (1, 2, 3):
        t = torch.relu(dense(params[f"trans_{i}"], t, dt))
        if dt != torch.float32:
            t = t.to(dt).float()
    rgb = dense(params["static_rgb"], d, dt)
    t_rgb = dense(params["trans_rgb"], t, dt)
    if cfg.out_ch == 3:
        rgb = torch.sigmoid(rgb)
        t_rgb = torch.sigmoid(t_rgb)
    t_sigma = Fn.softplus(dense(params["trans_sigma"], t, dt))
    t_beta = Fn.softplus(dense(params["trans_beta"], t, dt))
    return torch.cat([rgb, static_sigma, t_rgb, t_sigma, t_beta], -1)


def lookup_hist_embedding(table: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """hist (N, hist_bin) int -> (N, hist_bin*dim): rows gathered per bin
    and flattened."""
    emb = table[hist.long()]                 # (N, hist_bin, dim)
    return emb.reshape(hist.shape[0], -1)
