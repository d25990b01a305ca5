"""Model factory: the NeRF-H bundle (coarse + fine + embeddings + the
optional proposal sampler), or with NeRFH=False the vanilla-NeRF pair,
from a Config (port of dfnet_tpu/models/factory.py, with the same param
names and shapes)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from dfnet_tpu_torch.config import Config
from dfnet_tpu_torch.models.embedder import get_embedder
from dfnet_tpu_torch.models.nerf_vanilla import VanillaNeRFConfig, init_nerf_params
from dfnet_tpu_torch.models.nerfw import (
    NeRFWConfig,
    init_embeddings,
    init_nerfw_params,
    init_sigma_mlp,
)
from dfnet_tpu_torch.render.volume import NeRFHModel, RenderSettings, VanillaNeRFModel


def create_nerfh(cfg: Config, gen: Optional[torch.Generator] = None,
                 device="cpu") -> Tuple[Union[NeRFHModel, VanillaNeRFModel], Dict]:
    """Returns (static model description, param tree on `device`): the
    NeRF-H bundle, or with NeRFH=False the vanilla-NeRF pair (the
    reference's create_nerf dispatch). Params are drawn from `gen` (a CPU
    generator seeded with cfg.rng_seed by default)."""
    if gen is None:
        gen = torch.Generator().manual_seed(cfg.rng_seed)
    embed_xyz = get_embedder(cfg.multires, cfg.i_embed, cfg.reduce_embedding,
                             cfg.epochToMaxFreq, input_dims=3)
    embed_dir = get_embedder(cfg.multires_views, cfg.i_embed, cfg.reduce_embedding,
                             cfg.epochToMaxFreq, input_dims=3)
    if not cfg.NeRFH:
        return _create_vanilla(cfg, gen, device, embed_xyz, embed_dir)
    dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
    cfg_coarse = NeRFWConfig(
        D=cfg.netdepth, W=cfg.netwidth, in_xyz=embed_xyz.out_dim,
        in_dir=embed_dir.out_dim, out_ch=cfg.out_channel_size,
        compute_dtype=dtype)
    cfg_fine = NeRFWConfig(
        D=cfg.netdepth_fine, W=cfg.netwidth_fine, in_xyz=embed_xyz.out_dim,
        in_dir=embed_dir.out_dim, in_a=cfg.in_channels_a, in_t=cfg.in_channels_t,
        encode_appearance=True, encode_transient=True, beta_min=cfg.beta_min,
        out_ch=cfg.out_channel_size, compute_dtype=dtype)

    params = {"coarse": init_nerfw_params(gen, cfg_coarse, device)}
    cfg_proposal = embed_proposal = None
    if cfg.proposal and cfg.N_importance > 0:
        embed_proposal = get_embedder(cfg.proposal_multires, cfg.i_embed,
                                      input_dims=3)
        cfg_proposal = NeRFWConfig(
            D=cfg.proposal_D, W=cfg.proposal_W, skips=(),
            in_xyz=embed_proposal.out_dim, in_dir=embed_dir.out_dim,
            compute_dtype=dtype)
        params["proposal"] = init_sigma_mlp(gen, cfg_proposal, device)
    if cfg.N_importance > 0:
        params["fine"] = init_nerfw_params(gen, cfg_fine, device)
        # hist mode: hist_bin rows of (in_a/hist_bin) dims are gathered and
        # flattened; index mode: one full-width row per frame id
        if cfg.encode_hist:
            n_a, n_tau = (cfg.in_channels_a // cfg.hist_bin,
                          cfg.in_channels_t // cfg.hist_bin)
        else:
            n_a, n_tau = cfg.in_channels_a, cfg.in_channels_t
        emb = init_embeddings(gen, cfg.N_vocab, n_a=n_a, n_tau=n_tau,
                              device=device)
        params["embedding_a"] = emb["a"]
        params["embedding_t"] = emb["t"]

    model = NeRFHModel(cfg_coarse=cfg_coarse, cfg_fine=cfg_fine,
                       embed_xyz=embed_xyz, embed_dir=embed_dir,
                       cfg_proposal=cfg_proposal,
                       embed_proposal=embed_proposal)
    return model, params


def _create_vanilla(cfg: Config, gen: torch.Generator, device, embed_xyz, embed_dir):
    """The vanilla pair: no proposal net and no embeddings. output_ch is 5
    when there is a fine net, as in the reference (5 outputs, 4 read)."""
    dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
    out_ch = 5 if cfg.N_importance > 0 else 4
    cfg_c, cfg_f = (VanillaNeRFConfig(
        D=D, W=W, in_xyz=embed_xyz.out_dim, in_dir=embed_dir.out_dim,
        use_viewdirs=cfg.use_viewdirs, output_ch=out_ch, compute_dtype=dtype)
        for D, W in ((cfg.netdepth, cfg.netwidth),
                     (cfg.netdepth_fine, cfg.netwidth_fine)))
    params = {"coarse": init_nerf_params(gen, cfg_c, device)}
    if cfg.N_importance > 0:
        params["fine"] = init_nerf_params(gen, cfg_f, device)
    return VanillaNeRFModel(cfg_coarse=cfg_c, cfg_fine=cfg_f, embed_xyz=embed_xyz,
                            embed_dir=embed_dir), params


def render_settings(cfg: Config, near: float, far: float,
                    test: bool = False) -> RenderSettings:
    s = RenderSettings(
        N_samples=cfg.N_samples, N_importance=cfg.N_importance,
        perturb=cfg.perturb, raw_noise_std=cfg.raw_noise_std,
        lindisp=cfg.lindisp, white_bkgd=cfg.white_bkgd,
        near=float(near), far=float(far),
        fine_importance_only=cfg.fine_importance_only,
        train_cull_q=cfg.train_cull_q,
        train_fine_total=cfg.train_fine_total)
    return s.test() if test else s
