"""Volume rendering (port of dfnet_tpu/render/volume.py).

NeRF-W compositing (1e2 terminal delta, no ray-norm scaling of deltas,
shifted-cumprod transmittance; at test time rgb stays the static +
transient composite while depth/disp re-composite static-only) and the
coarse -> fine pipeline at train and test settings. This is the plain
renderer that the kernel routes (render/fast.py, render/fused_train.py)
fall back to where `render/fast.py::kernels_serve` refuses a model; it is
differentiable in the params and the rays.

The vanilla NeRF (NeRFH=False) has its own compositing (composite_vanilla:
1e10 terminal delta, deltas scaled by |rays_d|) and pipeline
(render_rays_vanilla); the full-image renders dispatch on the model. The
kernel gate admits it too (the JAX package's takes NeRFHModel only): its
stage-1 step and test render then take render/fused_train.py and
render/fast.py, and this is its plain route.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Union

import torch

from dfnet_tpu_torch.models.embedder import Embedder
from dfnet_tpu_torch.models.nerf_vanilla import VanillaNeRFConfig, nerf_apply_rays
from dfnet_tpu_torch.models.nerfw import (
    NeRFWConfig,
    lookup_hist_embedding,
    nerfw_apply_rays,
)
from dfnet_tpu_torch.parallel.mesh import gather_rows, row_counts, shard_rows
from dfnet_tpu_torch.render.rays import get_rays
from dfnet_tpu_torch.render.sampling import (
    gaussian,
    nerfw_deltas,
    sample_pdf,
    sample_pdf_culled,
    stratified_z_vals,
    transmittance,
)


@dataclass(frozen=True)
class RenderSettings:
    N_samples: int = 64
    N_importance: int = 64
    perturb: float = 1.0
    raw_noise_std: float = 0.0
    lindisp: bool = False
    white_bkgd: bool = False
    test_time: bool = False
    near: float = 0.0
    far: float = 1.0
    # fine MLP at the importance samples only (not the union with the
    # coarse z's); must be used at both train and test time
    fine_importance_only: bool = False
    train_cull_q: float = 0.0
    train_fine_total: int = 0

    def test(self) -> "RenderSettings":
        return replace(self, perturb=0.0, raw_noise_std=0.0,
                       test_time=True, train_cull_q=0.0,
                       train_fine_total=0)


@dataclass(frozen=True)
class NeRFHModel:
    """Static model description (configs + embedders); params live in a
    separate tree {'coarse','fine','embedding_a','embedding_t'[,
    'proposal']}. cfg_proposal describes the optional sigma-only proposal
    sampler."""
    cfg_coarse: NeRFWConfig
    cfg_fine: NeRFWConfig
    embed_xyz: Embedder
    embed_dir: Embedder
    cfg_proposal: Optional[NeRFWConfig] = None
    embed_proposal: Optional[Embedder] = None


def composite_nerfw(raw, z_vals, output_transient: bool, beta_min: float = 0.1,
                    white_bkgd: bool = False, test_time: bool = False,
                    raw_noise: Optional[torch.Tensor] = None,
                    sigma_only: bool = False, out_ch: int = 3) -> Dict:
    """NeRF-W compositing of activated MLP outputs along each ray.
    raw: (N, S, C) with C = out_ch+1 (static), 2*out_ch+3 (transient) or
    1 (sigma_only). raw_noise (N, S) is added to the static sigma (then
    relu'd) of a static composite."""
    deltas = nerfw_deltas(z_vals)

    if sigma_only:
        alphas = 1.0 - torch.exp(-deltas * raw[..., 0])
        weights = alphas * transmittance(alphas)
        return {"weights": weights, "acc": weights.sum(-1)}

    static_rgbs = raw[..., :out_ch]
    static_sigmas = raw[..., out_ch]
    if output_transient:
        transient_rgbs = raw[..., out_ch + 1: 2 * out_ch + 1]
        transient_sigmas = raw[..., 2 * out_ch + 1]
        transient_betas = raw[..., 2 * out_ch + 2]
        static_alphas = 1.0 - torch.exp(-deltas * static_sigmas)
        transient_alphas = 1.0 - torch.exp(-deltas * transient_sigmas)
        alphas = 1.0 - torch.exp(-deltas * (static_sigmas + transient_sigmas))
    else:
        sig = static_sigmas
        if raw_noise is not None:
            sig = torch.relu(sig + raw_noise)
        alphas = 1.0 - torch.exp(-deltas * sig)

    trans = transmittance(alphas)
    weights = alphas * trans
    weights_sum = weights.sum(-1)
    out: Dict = {"weights": weights, "acc": weights_sum}

    if output_transient:
        static_w = static_alphas * trans
        transient_w = transient_alphas * trans
        static_rgb_map = (static_w[..., None] * static_rgbs).sum(-2)
        if white_bkgd:
            static_rgb_map = static_rgb_map + (1.0 - weights_sum[..., None])
        transient_rgb_map = (transient_w[..., None] * transient_rgbs).sum(-2)
        beta = (transient_w * transient_betas).sum(-1) + beta_min
        out.update(rgb=static_rgb_map + transient_rgb_map, beta=beta,
                   transient_sigmas=transient_sigmas,
                   rgb_static=static_rgb_map, rgb_transient=transient_rgb_map)
        if test_time:
            s_trans = transmittance(static_alphas)
            static_w_ = static_alphas * s_trans
            depth = (static_w_ * z_vals).sum(-1)
            out["rgb_fine_static"] = (static_w_[..., None] * static_rgbs).sum(-2)
        else:
            depth = (weights * z_vals).sum(-1)
    else:
        rgb_map = (weights[..., None] * static_rgbs).sum(-2)
        if white_bkgd:
            rgb_map = rgb_map + (1.0 - weights_sum[..., None])
        out["rgb"] = rgb_map
        depth = (weights * z_vals).sum(-1)

    out["depth"] = depth
    out["disp"] = 1.0 / torch.clamp(depth / torch.clamp(weights_sum, min=1e-10),
                                    min=1e-10)
    return out


def render_rays(params: Dict, model: NeRFHModel, rays_o: torch.Tensor,
                rays_d: torch.Tensor, hist: torch.Tensor,
                settings: RenderSettings,
                gen: Optional[torch.Generator] = None,
                epoch: Optional[float] = None) -> Dict:
    """Render a batch of rays through coarse + fine NeRF-H. At test time
    the coarse pass is sigma-only and the importance samples are
    deterministic; at train time the coarse pass is the full static
    NeRF-W, with stratified jitter (perturb > 0), sigma noise
    (raw_noise_std > 0) and random importance samples drawn from `gen`,
    in that order. Fine z samples carry no gradient, as in the reference.
    `epoch` reaches every xyz and direction embedding: it sets the
    frequency window of a windowed embedder (--reduce_embedding 2) and
    is ignored by the others."""
    n = rays_o.shape[0]
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    near = torch.full((n, 1), settings.near, device=rays_o.device)
    far = torch.full((n, 1), settings.far, device=rays_o.device)
    z_vals = stratified_z_vals(near, far, settings.N_samples, gen,
                               settings.lindisp, settings.perturb)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    cfgc = model.cfg_coarse
    out: Dict = {}
    if settings.test_time:
        raw_c = nerfw_apply_rays(params["coarse"], cfgc, model.embed_xyz(pts, epoch),
                                 sigma_only=True)
        comp_c = composite_nerfw(raw_c, z_vals, output_transient=False,
                                 sigma_only=True)
    else:
        raw_c = nerfw_apply_rays(params["coarse"], cfgc, model.embed_xyz(pts, epoch),
                                 model.embed_dir(viewdirs, epoch), output_transient=False)
        noise = None
        if settings.raw_noise_std > 0.0 and gen is not None:
            noise = settings.raw_noise_std * gaussian(raw_c.shape[:-1], gen,
                                                      rays_o.device)
        comp_c = composite_nerfw(raw_c, z_vals, output_transient=False,
                                 white_bkgd=settings.white_bkgd, raw_noise=noise,
                                 out_ch=cfgc.out_ch)
        out.update(rgb0=comp_c["rgb"], disp0=comp_c["disp"], acc0=comp_c["acc"])
    if settings.N_importance <= 0:
        out["acc"] = comp_c["acc"]
        if not settings.test_time:
            out.update(rgb=comp_c["rgb"], disp=comp_c["disp"])
        return out

    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    if settings.train_cull_q > 0.0 and not settings.test_time:
        S, I = settings.N_samples, settings.N_importance
        z_all = sample_pdf_culled(z_mid, comp_c["weights"][..., 1:-1],
                                  settings.train_fine_total or (S + I),
                                  lam=S / (S + I), q=settings.train_cull_q,
                                  gen=gen if settings.perturb > 0.0 else None)
        z_samples = z_all
    else:
        z_samples = sample_pdf(z_mid, comp_c["weights"][..., 1:-1],
                               settings.N_importance, gen,
                               det=(settings.perturb == 0.0))
        if settings.fine_importance_only:
            z_all = torch.sort(z_samples, -1).values
        else:
            z_all = torch.sort(torch.cat([z_vals, z_samples], -1), -1).values
    pts_f = rays_o[:, None, :] + rays_d[:, None, :] * z_all[..., None]
    cfgf = model.cfg_fine
    dir_emb = model.embed_dir(viewdirs, epoch)
    a_emb = lookup_hist_embedding(params["embedding_a"], hist)
    t_emb = lookup_hist_embedding(params["embedding_t"], hist)
    raw_f = nerfw_apply_rays(params["fine"], cfgf, model.embed_xyz(pts_f, epoch),
                             dir_emb, a_emb, t_emb, output_transient=True)
    comp_f = composite_nerfw(raw_f, z_all, output_transient=True,
                             beta_min=cfgf.beta_min,
                             white_bkgd=settings.white_bkgd,
                             test_time=settings.test_time, out_ch=cfgf.out_ch)
    out.update({k: comp_f[k] for k in ("rgb", "disp", "acc", "depth")})
    if not settings.test_time:
        out.update(beta=comp_f["beta"], transient_sigmas=comp_f["transient_sigmas"],
                   z_std=torch.std(z_samples, -1, correction=0), z_vals=z_vals,
                   z_all=z_all, weights_fine=comp_f["weights"])
    return out


def vanilla_weights(sigma, z_vals, rays_d, raw_noise: Optional[torch.Tensor] = None):
    """Original-NeRF weights (N, S) of raw sigma (N, S) at z (N, S): 1e10
    terminal delta, deltas scaled by |rays_d|, relu(sigma + noise),
    1 - alpha + 1e-10 in the transmittance product."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, 1e10 * torch.ones_like(dists[..., :1])], -1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)
    if raw_noise is not None:
        sigma = sigma + raw_noise
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1), -1
    )[..., :-1]
    return alpha * trans


def composite_vanilla(raw, z_vals, rays_d, raw_noise: Optional[torch.Tensor] = None,
                      white_bkgd: bool = False) -> Dict:
    """Original-NeRF compositing of raw outputs (N, S, >=4): sigmoid rgb
    over vanilla_weights."""
    weights = vanilla_weights(raw[..., 3], z_vals, rays_d, raw_noise)
    rgb_map = (weights[..., None] * torch.sigmoid(raw[..., :3])).sum(-2)
    depth = (weights * z_vals).sum(-1)
    acc = weights.sum(-1)
    disp = 1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-10), min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc[..., None])
    return {"rgb": rgb_map, "disp": disp, "acc": acc, "weights": weights, "depth": depth}


@dataclass(frozen=True)
class VanillaNeRFModel:
    """Static description of the non-NeRFH (vanilla NeRF) pair; params live
    in a separate tree {'coarse'[, 'fine']}. It has no proposal sampler."""
    cfg_coarse: VanillaNeRFConfig
    cfg_fine: VanillaNeRFConfig
    embed_xyz: Embedder
    embed_dir: Embedder
    cfg_proposal = None


def vanilla_pass(params: Dict, cfg: VanillaNeRFConfig, embed_xyz: Embedder,
                 rays_o: torch.Tensor, rays_d: torch.Tensor, z: torch.Tensor,
                 dir_emb: torch.Tensor, settings: RenderSettings,
                 gen: Optional[torch.Generator] = None,
                 epoch: Optional[float] = None) -> Dict:
    """One net of the vanilla pair at samples z (N, S): the MLP, sigma noise
    from `gen` when raw_noise_std > 0, composite_vanilla."""
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    raw = nerf_apply_rays(params, cfg, embed_xyz(pts, epoch), dir_emb)
    noise = None
    if settings.raw_noise_std > 0.0 and gen is not None:
        noise = settings.raw_noise_std * gaussian(raw.shape[:-1], gen, rays_o.device)
    return composite_vanilla(raw, z, rays_d, raw_noise=noise, white_bkgd=settings.white_bkgd)


def render_rays_vanilla(params: Dict, model: VanillaNeRFModel, rays_o: torch.Tensor,
                        rays_d: torch.Tensor, settings: RenderSettings,
                        gen: Optional[torch.Generator] = None,
                        epoch: Optional[float] = None) -> Dict:
    """The original-NeRF coarse -> fine pipeline: stratified z (jittered
    when perturb > 0), the coarse composite with sigma noise, importance
    samples from its weights (deterministic when perturb == 0), then the
    fine net over the sorted union. Random draws come from `gen` in that
    order: the jitter, the coarse noise, the samples, the fine noise. Fine
    z samples carry no gradient. `epoch` as in render_rays."""
    n = rays_o.shape[0]
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    near = torch.full((n, 1), settings.near, device=rays_o.device)
    far = torch.full((n, 1), settings.far, device=rays_o.device)
    z_vals = stratified_z_vals(near, far, settings.N_samples, gen,
                               settings.lindisp, settings.perturb)
    dir_emb = model.embed_dir(viewdirs, epoch)
    comp_c = vanilla_pass(params["coarse"], model.cfg_coarse, model.embed_xyz, rays_o,
                          rays_d, z_vals, dir_emb, settings, gen, epoch)
    keys = ("rgb", "disp", "acc", "depth")
    if settings.N_importance <= 0:
        return {k: comp_c[k] for k in keys}
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(z_mid, comp_c["weights"][..., 1:-1], settings.N_importance,
                           gen, det=(settings.perturb == 0.0))
    z_all = torch.sort(torch.cat([z_vals, z_samples], -1), -1).values
    comp_f = vanilla_pass(params["fine"], model.cfg_fine, model.embed_xyz, rays_o, rays_d,
                          z_all, dir_emb, settings, gen, epoch)
    out = {k: comp_f[k] for k in keys}
    out.update(rgb0=comp_c["rgb"], disp0=comp_c["disp"], acc0=comp_c["acc"],
               z_std=torch.std(z_samples, -1, correction=0))
    return out


def chunked_rays(H: int, W: int, focal: float, c2w: torch.Tensor, chunk: int,
                 mesh=None):
    """Flattened rays of one view, padded to a multiple of `chunk`
    (origins 0, directions 1 on the pad) and split into chunks: (n, origin
    chunks, direction chunks). With a mesh, only this rank's rows of the
    view (parallel/mesh.py::shard_rows), and n is their count."""
    rays_o, rays_d = get_rays(H, W, focal, c2w)
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    if mesh is not None:
        lo, hi = shard_rows(rays_o.shape[0])
        rays_o, rays_d = rays_o[lo:hi], rays_d[lo:hi]
    n = rays_o.shape[0]
    n_pad = -n % chunk
    rays_o = torch.cat([rays_o, rays_o.new_zeros((n_pad, 3))], 0)
    rays_d = torch.cat([rays_d, rays_d.new_ones((n_pad, 3))], 0)
    return n, rays_o.split(chunk), rays_d.split(chunk)


IMAGE_KEYS = ("rgb", "disp", "acc")


def gather_image(outs, n: int, H: int, W: int, mesh=None) -> Dict:
    """Concatenate per-chunk rgb/disp/acc maps and cut the pad. With a
    mesh, each rank holds its rows of the view: they are gathered in one
    all-gather (autograd through it, parallel/mesh.py::gather_rows)."""
    cols = [torch.cat([o[k] for o in outs], 0)[:n] for k in IMAGE_KEYS]
    if mesh is not None:
        flat = gather_rows(torch.cat([c.reshape(n, -1) for c in cols], 1),
                           row_counts(H * W))
        widths = [c[0].numel() for c in cols]
        cols = [part.reshape((H * W,) + c.shape[1:])
                for part, c in zip(flat.split(widths, 1), cols)]
    return {k: v.reshape((H, W) + v.shape[1:]) for k, v in zip(IMAGE_KEYS, cols)}


def render_image_grad(params: Dict, model: Union[NeRFHModel, VanillaNeRFModel],
                      c2w: torch.Tensor, hist: torch.Tensor, H: int, W: int,
                      focal: float, settings: RenderSettings, chunk: int = 1024 * 8,
                      epoch: Optional[float] = None, mesh=None) -> Dict:
    """Full-image render: flatten rays, pad to a chunk multiple and render
    fixed-size chunks in turn (the reference's batchify_rays), through
    render_rays_vanilla for a vanilla model (which reads no hist) and
    render_rays otherwise. Autograd stays on: the result is differentiable
    in c2w and the params (stage 3's pose gradients). `epoch` as in
    render_rays. With a mesh (parallel/mesh.py) each rank renders its
    slice of the ray axis and the slices are gathered with autograd, so
    a pose gradient reaches every rank's rays (the JAX package's
    render_image(shard=...))."""
    n, ro, rd = chunked_rays(H, W, focal, c2w, chunk, mesh)
    if isinstance(model, VanillaNeRFModel):
        outs = [render_rays_vanilla(params, model, o, d, settings, epoch=epoch)
                for o, d in zip(ro, rd)]
    else:
        hist_b = hist[None].expand((chunk,) + hist.shape)
        outs = [render_rays(params, model, o, d, hist_b, settings, epoch=epoch)
                for o, d in zip(ro, rd)]
    return gather_image(outs, n, H, W, mesh)


@torch.no_grad()
def render_image(params: Dict, model: Union[NeRFHModel, VanillaNeRFModel], c2w: torch.Tensor,
                 hist: torch.Tensor, H: int, W: int, focal: float,
                 settings: RenderSettings, chunk: int = 1024 * 8,
                 epoch: Optional[float] = None, mesh=None) -> Dict:
    """render_image_grad without autograd (evaluation renders)."""
    return render_image_grad(params, model, c2w, hist, H, W, focal, settings, chunk,
                             epoch, mesh)
