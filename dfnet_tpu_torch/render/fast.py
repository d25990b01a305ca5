"""Fast test-time render path: the CUDA MLP sweep kernels + plain PyTorch
sampling and compositing (port of dfnet_tpu/render/fast.py).

Drop-in replacement for render_rays at test time (perturb=0, no noise,
no gradients): the placement sigma sweep and the fine NeRF-W sweep run
as kernels (ops/nerf_kernels.py) that take rays + z samples and return
channel-major pre-activation outputs; sampling and compositing run as
tensor ops on (N, S) arrays.

Importance-sampling modes (as in the JAX package):
  - exact union (default; reference semantics): importance samples from
    the placement CDF sorted together with the placement z's;
  - blended CDF: all fine z's drawn in one inverse-CDF pass from
    (1-lam)*cdf + lam*uniform, sorted by construction;
  - culled (cull_q > 0): the blended draw restricted to each ray's
    [q, 1-q] CDF-quantile interval, usually with fewer fine samples;
  - fuse_composite: the fine sweep and the NeRF-W composite in one kernel
    (fine_composite_t);
  - mono (opt-in, blended only): sampling (proposal sweep -> weights ->
    blended inverse CDF, proposal_z_rows) and the fine sweep + composite
    (fine_composite_t) run as two kernel launches with no per-point tensor
    ops between them. It needs a packed proposal, exact_union=False and
    lindisp=False; otherwise the call takes the two-kernel path, as in the
    JAX package.

The vanilla NeRF (NeRFH=False) renders on the exact union only: the coarse
net's sigma sweep places the samples (coarse_sigma_t on its sigma-only
pack), the fine net's sweep is fine_raw_t on its static pack, whose
channel-major rows volume.composite_vanilla composites. The other
schedules keep it on the plain renderer (`kernels_serve`).

A caller that renders many views with one set of weights passes a
PackCache: the weights are packed for the kernels once per weight version
(a miss) and reused on every later view (a hit), counted in PACKS.

Under a torch.profiler trace (utils/profiling.py::annotate) a view is the
region `dfnet.render.view`, holding `dfnet.render.pack` (the pack, or the
PackCache lookup) and, per chunk, `dfnet.render.placement`, `.sample`,
`.fine` and `.composite`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as Fn

from dfnet_tpu_torch.models.nerfw import lookup_hist_embedding
from dfnet_tpu_torch.ops import nerf_kernels as nk
from dfnet_tpu_torch.render.sampling import (
    nerfw_deltas,
    sample_pdf,
    sample_pdf_blend,
    sample_pdf_culled,
    stratified_z_vals,
    transmittance,
)
from dfnet_tpu_torch.render.volume import (
    NeRFHModel,
    RenderSettings,
    VanillaNeRFModel,
    chunked_rays,
    composite_vanilla,
    gather_image,
    vanilla_weights,
)
from dfnet_tpu_torch.utils.profiling import annotate

LANES = 128     # the JAX package's lane width; kept for kernels_serve's envelope


@dataclass(frozen=True)
class FastNeRFH:
    """Kernel-packed NeRF-H (or vanilla pair) for fused test-time rendering."""
    model: Union[NeRFHModel, VanillaNeRFModel]
    packed_coarse: Dict
    packed_fine: Dict
    params: Dict                      # original params (per-ray partials)
    spec_coarse: nk.KernelSpec
    spec_fine: nk.KernelSpec
    packed_proposal: Optional[Dict] = None
    spec_proposal: Optional[nk.KernelSpec] = None

    @classmethod
    def pack(cls, params: Dict, model: Union[NeRFHModel, VanillaNeRFModel],
             use_proposal: bool = True) -> "FastNeRFH":
        if isinstance(model, VanillaNeRFModel):
            cc, cf, emb = model.cfg_coarse, model.cfg_fine, model.embed_xyz
            return cls(model=model,
                       packed_coarse=nk.pack_vanilla_t(params["coarse"], cc, emb,
                                                       sigma_only=True),
                       packed_fine=nk.pack_vanilla_t(params["fine"], cf, emb),
                       params=params,
                       spec_coarse=nk.vanilla_spec(cc, emb, static=False),
                       spec_fine=nk.vanilla_spec(cf, emb))
        packed_p = spec_p = None
        if (use_proposal and model.cfg_proposal is not None
                and "proposal" in params):
            emb_p = model.embed_proposal or model.embed_xyz
            packed_p = nk.pack_coarse_t(params["proposal"], model.cfg_proposal,
                                        emb_p)
            spec_p = nk.spec_of(model.cfg_proposal, emb_p, fine=False)
        return cls(
            model=model,
            packed_coarse=nk.pack_coarse_t(params["coarse"], model.cfg_coarse,
                                           model.embed_xyz),
            packed_fine=nk.pack_fine_t(params["fine"], model.cfg_fine,
                                       model.embed_xyz),
            params=params,
            spec_coarse=nk.spec_of(model.cfg_coarse, model.embed_xyz, fine=False),
            spec_fine=nk.spec_of(model.cfg_fine, model.embed_xyz, fine=True),
            packed_proposal=packed_p,
            spec_proposal=spec_p,
        )


PACKS = {"hits": 0, "misses": 0}       # PackCache lookups, every cache


def _leaves(tree: Dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


class PackCache:
    """The FastNeRFH of the last weights packed, for a caller that renders
    many views: a lookup packs anew (a miss) unless the model, the
    proposal choice and every leaf of the params tree are those of the last
    pack, each leaf the same tensor at the same `_version`. An in-place
    write (an optimizer step, `add_`) bumps the version; a loaded or
    re-adopted tree brings new tensors. The leaves are held, so their ids
    are not reused. One entry; each caller owns its own."""

    def __init__(self):
        self._key = None
        self._fast: Optional[FastNeRFH] = None

    def get(self, params: Dict, model: NeRFHModel,
            use_proposal: bool = True) -> FastNeRFH:
        leaves = list(_leaves(params))
        key = self._key
        if (key is not None and key[0] is model and key[1] == use_proposal
                and len(key[2]) == len(leaves)
                and all(p == q and t is u and t._version == v
                        for (p, t), (q, u, v) in zip(leaves, key[2]))):
            PACKS["hits"] += 1
            return self._fast
        PACKS["misses"] += 1
        self._fast = FastNeRFH.pack(params, model, use_proposal=use_proposal)
        self._key = (model, use_proposal, [(p, t, t._version) for p, t in leaves])
        return self._fast


def composite_soa(raw9, z_all, white_bkgd: bool = False) -> Dict:
    """Test-time NeRF-W compositing from channel-major pre-activation raw
    (9, N, S) + z (N, S); same math as volume.composite_nerfw with
    test_time=True (combined rgb, static-only recomposite for depth and
    disp). beta is not produced: it feeds only the train loss."""
    srgb = torch.sigmoid(raw9[0:3])
    ssig = Fn.softplus(raw9[3])
    trgb = torch.sigmoid(raw9[4:7])
    tsig = Fn.softplus(raw9[7])

    deltas = nerfw_deltas(z_all)
    static_alphas = 1.0 - torch.exp(-deltas * ssig)
    transient_alphas = 1.0 - torch.exp(-deltas * tsig)
    alphas = 1.0 - torch.exp(-deltas * (ssig + tsig))
    trans = transmittance(alphas)
    weights_sum = (alphas * trans).sum(-1)

    static_rgb = (static_alphas * trans * srgb).sum(-1).t()
    if white_bkgd:
        static_rgb = static_rgb + (1.0 - weights_sum[:, None])
    rgb = static_rgb + (transient_alphas * trans * trgb).sum(-1).t()

    static_w_ = static_alphas * transmittance(static_alphas)
    depth = (static_w_ * z_all).sum(-1)
    disp = 1.0 / torch.clamp(depth / torch.clamp(weights_sum, min=1e-10),
                             min=1e-10)
    return {"rgb": rgb, "disp": disp, "acc": weights_sum, "depth": depth,
            "rgb_static_only": (static_w_ * srgb).sum(-1).t()}


def _composited(out: torch.Tensor, white_bkgd: bool) -> Dict:
    """fine_composite_t's (8, N) rows -> the composite_soa dict."""
    rgb = out[0:3].t()
    acc, depth = out[3], out[4]
    if white_bkgd:
        rgb = rgb + (1.0 - acc)[:, None]
    disp = 1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-10), min=1e-10)
    return {"rgb": rgb, "disp": disp, "acc": acc, "depth": depth,
            "rgb_static_only": out[5:8].t()}


def _per_ray_conditioning(fast: FastNeRFH, rays_d, hist) -> torch.Tensor:
    """(N, W) per-ray rows of the fine net (view direction, appearance and
    transient embeddings). hist may be (1, HB): one histogram for every
    ray, gathered once."""
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    a_emb = lookup_hist_embedding(fast.params["embedding_a"], hist)
    t_emb = lookup_hist_embedding(fast.params["embedding_t"], hist)
    return nk.per_ray_row(fast.params["fine"], fast.model.cfg_fine,
                          fast.model.embed_dir(viewdirs), a_emb, t_emb)


@torch.no_grad()
def render_rays_fast(fast: FastNeRFH, rays_o, rays_d, hist,
                     settings: RenderSettings, exact_union: bool = True,
                     mono: Optional[bool] = None,
                     cull_q: float = 0.0, n_fine: Optional[int] = None,
                     n_place: Optional[int] = None,
                     fuse_composite: bool = False) -> Dict:
    """Test-time render of a ray batch through the kernels. Matches
    render_rays (test settings) up to bf16 kernel rounding when
    exact_union=True. cull_q > 0 selects the culled sampler, usually with
    n_fine < N_samples + N_importance; fuse_composite runs the fine sweep
    and the composite as one kernel. mono=True (with a packed proposal,
    exact_union=False and lindisp=False) samples in proposal_z_rows and
    composites in fine_composite_t: N_samples + N_importance fine samples,
    cull_q and n_fine unused, as in the JAX package."""
    if cull_q <= 0.0 and exact_union and (n_fine or n_place):
        raise ValueError(
            "n_fine/n_place (render_fine_total/render_place_samples) "
            "require cull_q > 0 or exact_union=False; the exact-union "
            "schedule always renders N_samples+N_importance samples")
    rays_o = rays_o.float().contiguous()
    rays_d = rays_d.float().contiguous()
    if isinstance(fast.model, VanillaNeRFModel):
        if cull_q > 0.0 or not exact_union or mono or fuse_composite:
            raise ValueError("the kernels render a vanilla NeRF on the exact union only")
        return _render_rays_fast_vanilla(fast, rays_o, rays_d, settings)
    S = n_place or settings.N_samples
    # the sampling kernel builds a linear-in-z uniform grid only: under
    # lindisp (or without a proposal, or for the exact union) the call
    # takes the two-kernel path, as the JAX package's schedule does
    mono_ok = (fast.packed_proposal is not None and not exact_union
               and not settings.lindisp)
    if mono and mono_ok:
        n_total = S + settings.N_importance
        with annotate("dfnet.render.placement"):
            z_all = nk.proposal_z_rows(fast.packed_proposal, rays_o, rays_d,
                                       fast.spec_proposal, S, n_total,
                                       float(settings.near), float(settings.far),
                                       lam=S / n_total)
        with annotate("dfnet.render.fine"):
            dpt = _per_ray_conditioning(fast, rays_d, hist)
            out = nk.fine_composite_t(fast.packed_fine, rays_o, rays_d, z_all, dpt,
                                      fast.spec_fine)
        with annotate("dfnet.render.composite"):
            return _composited(out, settings.white_bkgd)
    n = rays_o.shape[0]

    # sample placement: the trained proposal sampler when packed (same
    # uniform grid, much cheaper sigma sweep), else the coarse NeRF
    with annotate("dfnet.render.placement"):
        if fast.packed_proposal is not None:
            sig_pre = nk.coarse_sigma_t(fast.packed_proposal, rays_o, rays_d,
                                        fast.spec_proposal, S, float(settings.near),
                                        float(settings.far), settings.lindisp)
        else:
            sig_pre = nk.coarse_sigma_t(fast.packed_coarse, rays_o, rays_d,
                                        fast.spec_coarse, S, float(settings.near),
                                        float(settings.far), settings.lindisp)
        sigma = Fn.softplus(sig_pre)
        near = torch.full((n, 1), settings.near, device=rays_o.device)
        far = torch.full((n, 1), settings.far, device=rays_o.device)
        z_vals = stratified_z_vals(near, far, S, None, settings.lindisp, 0.0)
        alphas = 1.0 - torch.exp(-nerfw_deltas(z_vals) * sigma)
        weights = alphas * transmittance(alphas)

    with annotate("dfnet.render.sample"):
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        n_total = n_fine or (settings.N_samples + settings.N_importance)
        if cull_q > 0.0:
            lam = settings.N_samples / (settings.N_samples + settings.N_importance)
            z_all = sample_pdf_culled(z_mid, weights[..., 1:-1], n_total,
                                      lam=lam, q=cull_q)
        elif exact_union:
            z_samples = sample_pdf(z_mid, weights[..., 1:-1],
                                   settings.N_importance, None, det=True)
            z_all = torch.sort(torch.cat([z_vals, z_samples], -1), -1).values
        else:
            z_all = sample_pdf_blend(z_mid, weights[..., 1:-1], n_total,
                                     lam=S / n_total)
        z_all = z_all.contiguous()

    with annotate("dfnet.render.fine"):
        dpt = _per_ray_conditioning(fast, rays_d, hist)
        if fuse_composite:
            out = nk.fine_composite_t(fast.packed_fine, rays_o, rays_d, z_all,
                                      dpt, fast.spec_fine)
        else:
            raw9 = nk.fine_raw_t(fast.packed_fine, rays_o, rays_d, z_all, dpt,
                                 fast.spec_fine)
    with annotate("dfnet.render.composite"):
        if fuse_composite:
            return _composited(out, settings.white_bkgd)
        return composite_soa(raw9, z_all, white_bkgd=settings.white_bkgd)


def _render_rays_fast_vanilla(fast: FastNeRFH, rays_o, rays_d,
                              settings: RenderSettings) -> Dict:
    """render_rays_vanilla at test settings through the kernels: the coarse
    net's sigma sweep over the uniform grid places the samples, the fine
    net's static sweep runs over the sorted exact union."""
    n, S = rays_o.shape[0], settings.N_samples
    with annotate("dfnet.render.placement"):
        sig_pre = nk.coarse_sigma_t(fast.packed_coarse, rays_o, rays_d, fast.spec_coarse, S,
                                    float(settings.near), float(settings.far),
                                    settings.lindisp)
        near = torch.full((n, 1), settings.near, device=rays_o.device)
        far = torch.full((n, 1), settings.far, device=rays_o.device)
        z_vals = stratified_z_vals(near, far, S, None, settings.lindisp, 0.0)
        weights = vanilla_weights(sig_pre, z_vals, rays_d)
    with annotate("dfnet.render.sample"):
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sample_pdf(z_mid, weights[..., 1:-1], settings.N_importance, None,
                               det=True)
        z_all = torch.sort(torch.cat([z_vals, z_samples], -1), -1).values.contiguous()
    with annotate("dfnet.render.fine"):
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        dpt = nk.per_ray_row_vanilla(fast.params["fine"], fast.model.cfg_fine,
                                     fast.model.embed_dir(viewdirs))
        raw4 = nk.fine_raw_t(fast.packed_fine, rays_o, rays_d, z_all, dpt, fast.spec_fine)
    with annotate("dfnet.render.composite"):
        return composite_vanilla(raw4.permute(1, 2, 0), z_all, rays_d,
                                 white_bkgd=settings.white_bkgd)


def cull_schedule_kwargs(cfg) -> Dict:
    """cfg.render_* flags as render kwargs; n_fine/n_place are forwarded
    only when the culled sampler is on (the exact-union schedule's fine
    count is structural)."""
    q = float(cfg.render_cull_q or 0.0)
    if q <= 0.0:
        return {"cull_q": 0.0, "n_fine": None, "n_place": None}
    return {"cull_q": q, "n_fine": cfg.render_fine_total or None,
            "n_place": cfg.render_place_samples or None}


def _tileable(S: int, target: int = 2048) -> bool:
    """The JAX package's tile_geometry(S) succeeds: some ray count R <=
    min(LANES, target // S) makes R*S a multiple of 128. Kept as a gate so
    that both packages route the same NeRF-H settings to the same renderer
    (the JAX package renders a vanilla NeRF on its plain renderer only)."""
    R = max(1, min(LANES, target // S))
    return any((r * S) % 128 == 0 for r in range(R, 0, -1))


def _width_ok(w: int) -> bool:
    """A net width the kernels take: a multiple of 32, and up to 2*LANES
    in LANES steps."""
    return not (w % 32 or (w > LANES and (w % LANES != 0 or w > 2 * LANES)))


def kernels_serve(model, settings: RenderSettings, train: bool = False,
                  cull_q: float = 0.0) -> bool:
    """Whether the kernels serve this model under these settings: a
    test-time render (render_image_fast; `cull_q` its culled sampler) or,
    with `train`, a stage-1 step (render/fused_train.py; the cull is
    settings.train_cull_q). The one gate of the kernel route.

    The NeRF-H envelope is the JAX package's, less its CPU and Mosaic-width
    gates, plus the Hopper kernels' own: every width a multiple of 32
    (16-row WMMA tiles over the W/2-wide transient layers). A vanilla pair
    (the JAX package renders it plainly) takes the kernels unculled where
    both nets fit: viewdirs, skips they can place (nk.vanilla_skip) and an
    unwindowed PE that includes its input.

    The kernels always run bf16 matmuls with float32 accumulation
    regardless of --precision; pass --fast_render false (--fused_train
    false) for the plain float32 renderer (train step). On the CPU the
    kernel wrappers run their plain versions."""
    if not isinstance(model, (NeRFHModel, VanillaNeRFModel)):
        return False
    nets, F = (model.cfg_coarse, model.cfg_fine), model.embed_xyz.num_freqs
    cull = settings.train_cull_q if train else cull_q
    S = settings.N_samples
    S_fine = S + settings.N_importance
    if isinstance(model, VanillaNeRFModel):
        own = cull <= 0.0 and all(c.use_viewdirs and nk.vanilla_skip(c) is not None
                                  and c.in_xyz == 6 * F + 3 for c in nets)
    else:
        fine, proposal = model.cfg_fine, model.cfg_proposal
        own = (fine.out_ch == 3
               # a render places its samples with the proposal net's sweep
               and (train or proposal is None or proposal.W % 32 == 0)
               # the train step's fine sweep is the transient pack
               and (not train or fine.encode_transient))
        # the train step's fine count: the importance samples alone, or the
        # culled draw's total
        if train and settings.fine_importance_only:
            S_fine = settings.N_importance
        if train and cull > 0.0 and settings.train_fine_total:
            S_fine = settings.train_fine_total
    return (own and settings.N_importance > 0
            and all(_width_ok(c.W) for c in nets)
            and not (model.embed_xyz.windowed or model.embed_dir.windowed)
            and 6 * F + 3 <= LANES
            and _tileable(S) and _tileable(S_fine))


@torch.no_grad()
def render_image_fast(params: Dict, model: Union[NeRFHModel, VanillaNeRFModel], c2w,
                      hist, H: int, W: int, focal: float,
                      settings: RenderSettings, chunk: int = 1024 * 8,
                      exact_union: bool = True, use_proposal: bool = True,
                      cull_q: float = 0.0, n_fine: Optional[int] = None,
                      n_place: Optional[int] = None,
                      fuse_composite: bool = False,
                      packs: Optional[PackCache] = None, mesh=None) -> Dict:
    """Full-image render through the kernels (test-time drop-in for
    volume.render_image: same rgb/disp/acc keys). Rays are padded to a
    multiple of `chunk` and rendered one chunk at a time. Pass the
    caller's `packs` to pack the weights once per weight version rather
    than on every call. With a mesh (parallel/mesh.py) each rank renders
    its slice of the ray axis, with the kernels the one-device render
    launches on all of them, and the slices are gathered."""
    with annotate("dfnet.render.view"):
        with annotate("dfnet.render.pack"):
            if packs is None:
                fast = FastNeRFH.pack(params, model, use_proposal=use_proposal)
            else:
                fast = packs.get(params, model, use_proposal)
        n, ro, rd = chunked_rays(H, W, focal, c2w, chunk, mesh)
        # (1, HB): one histogram for every ray; a vanilla pair reads none
        hist_b = None if hist is None else hist[None]
        outs = [render_rays_fast(fast, o, d, hist_b, settings,
                                 exact_union=exact_union, cull_q=cull_q,
                                 n_fine=n_fine, n_place=n_place,
                                 fuse_composite=fuse_composite)
                for o, d in zip(ro, rd)]
        return gather_image(outs, n, H, W, mesh)
