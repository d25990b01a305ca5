"""Stage-1 training through the MLP sweep kernels (port of
dfnet_tpu/render/fused_train.py).

Both train-time MLP sweeps run as `fine_raw_t` under `RawSweep`, a
`torch.autograd.Function` whose backward is the `raw_bwd_t` kernel: the
coarse sweep on the static pack (S = N_samples, rows [rgb, sigma]) and the
fine sweep on the NeRF-W pack (S = N_samples + N_importance). Sampling,
compositing, the loss and Adam stay plain PyTorch, operating on the
kernels' channel-major (rows, N, S) output. A vanilla NeRF (NeRFH=False)
runs both of its nets on their static vanilla packs
(`render_rays_train_vanilla`), the fine one over the sorted union, and
volume.composite_vanilla composites their rows. The trainer takes this
route where `render/fast.py::kernels_serve(..., train=True)` admits the
model and its train settings.

Gradient contract (the JAX package's): cotangents reach the MLP params
(through the differentiable packs) and the per-ray conditioning rows
(-> appearance / transient embeddings and the per-ray halves of the dir
and transient-0 layers) ONLY. Rays and z samples get none, which is exact
for stage 1: the fine z's are drawn without gradient and the rays are
data. Stage 3 (gradients to the pose through the rays) must keep the
plain `render/volume.py::render_rays`.

Under a torch.profiler trace (utils/profiling.py::annotate) the render's
phases are the regions `dfnet.train.pack` (each pack), `.coarse`,
`.composite` (each composite), `.sample` and `.fine`, inside the step's
`dfnet.train.step` (training/nerf_trainer.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as Fn

from dfnet_tpu_torch.models.nerfw import lookup_hist_embedding
from dfnet_tpu_torch.ops import nerf_kernels as nk
from dfnet_tpu_torch.render.sampling import (
    gaussian,
    nerfw_deltas,
    sample_pdf,
    sample_pdf_culled,
    stratified_z_vals,
    transmittance,
)
from dfnet_tpu_torch.render.volume import (
    NeRFHModel,
    RenderSettings,
    VanillaNeRFModel,
    composite_vanilla,
)
from dfnet_tpu_torch.utils.profiling import annotate


class RawSweep(torch.autograd.Function):
    """Differentiable kernel sweep: fine_raw_t forward, raw_bwd_t backward.
    The forward saves only its inputs; the backward kernel recomputes the
    activations. Gradients flow to the packed weights and biases and to
    dpt; rays, z and the PE frequencies get none."""

    @staticmethod
    def forward(ctx, w, b, freqs, rays_o, rays_d, z_all, dpt, spec):
        ctx.spec = spec
        ctx.save_for_backward(w, b, freqs, rays_o, rays_d, z_all, dpt)
        return nk.fine_raw_t({"w": w, "b": b, "freqs": freqs}, rays_o, rays_d,
                             z_all, dpt, spec)

    @staticmethod
    def backward(ctx, g):
        w, b, freqs, rays_o, rays_d, z_all, dpt = ctx.saved_tensors
        d_w, d_b, d_dpt = nk.raw_bwd_t({"w": w, "b": b, "freqs": freqs}, rays_o,
                                       rays_d, z_all, dpt, g.float().contiguous(),
                                       ctx.spec)
        return d_w, d_b, None, None, None, None, d_dpt, None


def raw_sweep(packed: Dict, rays_o, rays_d, z_all, dpt, spec: nk.KernelSpec):
    """(rows, N, S) pre-activation output of fine_raw_t, differentiable in
    packed["w"], packed["b"] and dpt."""
    return RawSweep.apply(packed["w"], packed["b"], packed["freqs"], rays_o,
                          rays_d, z_all, dpt, spec)


# ---------------------------------------------------------------------------
# train-time composites of the channel-major raw rows
# ---------------------------------------------------------------------------

def composite_static_train(raw4, z_vals, white_bkgd: bool = False,
                           raw_noise: Optional[torch.Tensor] = None) -> Dict:
    """Coarse train composite from static raw rows [rgb 0:3, sigma 3]
    (pre-activation); volume.composite_nerfw(output_transient=False):
    softplus sigma (+ optional relu'd noise), sigmoid rgb, 1e2 terminal
    delta."""
    rgb = torch.sigmoid(raw4[0:3])                    # (3, N, S)
    sig = Fn.softplus(raw4[3])                        # (N, S)
    if raw_noise is not None:
        sig = torch.relu(sig + raw_noise)
    alphas = 1.0 - torch.exp(-nerfw_deltas(z_vals) * sig)
    weights = alphas * transmittance(alphas)
    acc = weights.sum(-1)
    rgb_map = (weights * rgb).sum(-1).t()
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc[:, None])
    depth = (weights * z_vals).sum(-1)
    disp = 1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-10), min=1e-10)
    return {"rgb": rgb_map, "disp": disp, "acc": acc, "depth": depth,
            "weights": weights}


def composite_nerfw_train(raw9, z_all, beta_min: float,
                          white_bkgd: bool = False) -> Dict:
    """Fine train composite from transient raw rows [rgb 0:3, sigma 3,
    t-rgb 4:7, t-sigma 7, t-beta 8] (pre-activation);
    volume.composite_nerfw(output_transient=True, test_time=False):
    combined rgb, beta_min added after the beta composite, depth from the
    combined weights."""
    srgb = torch.sigmoid(raw9[0:3])
    ssig = Fn.softplus(raw9[3])
    trgb = torch.sigmoid(raw9[4:7])
    tsig = Fn.softplus(raw9[7])
    tbeta = Fn.softplus(raw9[8])
    deltas = nerfw_deltas(z_all)
    static_alphas = 1.0 - torch.exp(-deltas * ssig)
    transient_alphas = 1.0 - torch.exp(-deltas * tsig)
    alphas = 1.0 - torch.exp(-deltas * (ssig + tsig))
    trans = transmittance(alphas)
    weights = alphas * trans
    acc = weights.sum(-1)
    transient_w = transient_alphas * trans
    static_rgb = (static_alphas * trans * srgb).sum(-1).t()
    if white_bkgd:
        static_rgb = static_rgb + (1.0 - acc[:, None])
    transient_rgb = (transient_w * trgb).sum(-1).t()
    depth = (weights * z_all).sum(-1)
    disp = 1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-10), min=1e-10)
    return {"rgb": static_rgb + transient_rgb,
            "beta": (transient_w * tbeta).sum(-1) + beta_min,
            "transient_sigmas": tsig, "weights": weights, "acc": acc,
            "depth": depth, "disp": disp}


# ---------------------------------------------------------------------------
# fused train render
# ---------------------------------------------------------------------------

def render_rays_train_fused(params: Dict, model: NeRFHModel, rays_o, rays_d,
                            hist, settings: RenderSettings,
                            gen: Optional[torch.Generator] = None) -> Dict:
    """Drop-in for volume.render_rays at train time (NeRF-H transient
    models): the same sampling, composites and output keys, with both MLP
    sweeps running as kernels under RawSweep. `gen` (on the rays' device)
    draws, in order, the stratified jitter, the coarse sigma noise and the
    importance samples, as volume.render_rays does. A vanilla pair goes to
    render_rays_train_vanilla (it reads no hist)."""
    if isinstance(model, VanillaNeRFModel):
        return render_rays_train_vanilla(params, model, rays_o, rays_d, settings, gen)
    rays_o = rays_o.float().contiguous()
    rays_d = rays_d.float().contiguous()
    n = rays_o.shape[0]
    S = settings.N_samples
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    near = torch.full((n, 1), settings.near, device=rays_o.device)
    far = torch.full((n, 1), settings.far, device=rays_o.device)
    z_vals = stratified_z_vals(near, far, S, gen, settings.lindisp,
                               settings.perturb).contiguous()

    cfgc, cfgf = model.cfg_coarse, model.cfg_fine
    dir_emb = model.embed_dir(viewdirs)

    # ---- coarse sweep (the full static pass at train time)
    with annotate("dfnet.train.pack"):
        packed_c = nk.pack_static_t(params["coarse"], cfgc, model.embed_xyz)
        spec_c = nk.spec_of(cfgc, model.embed_xyz, fine=False, static=True)
    with annotate("dfnet.train.coarse"):
        dpt_c = nk.per_ray_row_static(params["coarse"], cfgc, dir_emb)
        raw_c = raw_sweep(packed_c, rays_o, rays_d, z_vals, dpt_c, spec_c)
        noise = None
        if settings.raw_noise_std > 0.0 and gen is not None:
            noise = settings.raw_noise_std * gaussian((n, S), gen, rays_o.device)
    with annotate("dfnet.train.composite"):
        comp_c = composite_static_train(raw_c, z_vals, white_bkgd=settings.white_bkgd,
                                        raw_noise=noise)
    out: Dict = {"rgb0": comp_c["rgb"], "disp0": comp_c["disp"],
                 "acc0": comp_c["acc"]}

    # ---- fine sampling (detached inverse-CDF union, or the culled profile)
    with annotate("dfnet.train.sample"):
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        if settings.train_cull_q > 0.0:
            lam = S / (S + settings.N_importance)
            nf = settings.train_fine_total or (S + settings.N_importance)
            z_all = sample_pdf_culled(z_mid, comp_c["weights"][..., 1:-1], nf, lam=lam,
                                      q=settings.train_cull_q,
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
        z_all = z_all.detach().contiguous()

    # ---- fine sweep (transient)
    with annotate("dfnet.train.pack"):
        packed_f = nk.pack_fine_t(params["fine"], cfgf, model.embed_xyz)
        spec_f = nk.spec_of(cfgf, model.embed_xyz, fine=True)
    with annotate("dfnet.train.fine"):
        a_emb = lookup_hist_embedding(params["embedding_a"], hist)
        t_emb = lookup_hist_embedding(params["embedding_t"], hist)
        dpt_f = nk.per_ray_row(params["fine"], cfgf, dir_emb, a_emb, t_emb)
        raw_f = raw_sweep(packed_f, rays_o, rays_d, z_all, dpt_f, spec_f)
    with annotate("dfnet.train.composite"):
        comp_f = composite_nerfw_train(raw_f, z_all, beta_min=cfgf.beta_min,
                                       white_bkgd=settings.white_bkgd)
    out.update(rgb=comp_f["rgb"], disp=comp_f["disp"], acc=comp_f["acc"],
               depth=comp_f["depth"], beta=comp_f["beta"],
               transient_sigmas=comp_f["transient_sigmas"],
               z_std=torch.std(z_samples, -1, correction=0),
               z_vals=z_vals, z_all=z_all, weights_fine=comp_f["weights"])
    return out


def render_rays_train_vanilla(params: Dict, model: VanillaNeRFModel, rays_o, rays_d,
                              settings: RenderSettings,
                              gen: Optional[torch.Generator] = None) -> Dict:
    """Drop-in for volume.render_rays_vanilla at train time: the same
    draws from `gen` in its order (the jitter, the coarse sigma noise, the
    importance samples, the fine sigma noise), composites and output keys,
    with each net's sweep as fine_raw_t on its static vanilla pack under
    RawSweep: the coarse at N_samples, the fine over the sorted union of
    N_samples + N_importance."""
    rays_o = rays_o.float().contiguous()
    rays_d = rays_d.float().contiguous()
    n, S, dev = rays_o.shape[0], settings.N_samples, rays_o.device
    near = torch.full((n, 1), settings.near, device=dev)
    far = torch.full((n, 1), settings.far, device=dev)
    z_vals = stratified_z_vals(near, far, S, gen, settings.lindisp,
                               settings.perturb).contiguous()
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    dir_emb = model.embed_dir(viewdirs)

    def sweep(net: str, cfg, z):
        with annotate("dfnet.train.pack"):
            packed = nk.pack_vanilla_t(params[net], cfg, model.embed_xyz)
            spec = nk.vanilla_spec(cfg, model.embed_xyz)
        with annotate(f"dfnet.train.{net}"):
            dpt = nk.per_ray_row_vanilla(params[net], cfg, dir_emb)
            raw = raw_sweep(packed, rays_o, rays_d, z, dpt, spec)
            noise = None
            if settings.raw_noise_std > 0.0 and gen is not None:
                noise = settings.raw_noise_std * gaussian(z.shape, gen, dev)
        with annotate("dfnet.train.composite"):
            return composite_vanilla(raw.permute(1, 2, 0), z, rays_d, noise,
                                     settings.white_bkgd)

    comp_c = sweep("coarse", model.cfg_coarse, z_vals)
    with annotate("dfnet.train.sample"):
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sample_pdf(z_mid, comp_c["weights"][..., 1:-1], settings.N_importance,
                               gen, det=(settings.perturb == 0.0))
        z_all = torch.sort(torch.cat([z_vals, z_samples], -1), -1).values
        z_all = z_all.detach().contiguous()
    comp_f = sweep("fine", model.cfg_fine, z_all)
    out = {k: comp_f[k] for k in ("rgb", "disp", "acc", "depth")}
    out.update(rgb0=comp_c["rgb"], disp0=comp_c["disp"], acc0=comp_c["acc"],
               z_std=torch.std(z_samples, -1, correction=0))
    return out
