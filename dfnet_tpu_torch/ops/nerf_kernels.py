"""NeRF-H MLP sweep kernels for Hopper: packing, wrappers, plain versions.

Port of the kernels of dfnet_tpu/ops/nerf_kernels.py (the layer-stack
probe's pair is in ops/mlp_stack.py):

  coarse_sigma_t    <- nerf_kernels.py::coarse_sigma_t (_coarse_kernel_t)
  fine_raw_t        <- nerf_kernels.py::fine_raw_t (_fine_kernel_t), with
                       the fine (NeRF-W) and the static (train-time coarse)
                       packs
  fine_composite_t  <- nerf_kernels.py::fine_composite_t
                       (_fine_composite_kernel_t)
  raw_bwd_t         <- nerf_kernels.py::raw_bwd_t (_bwd_kernel_t): the
                       backward of fine_raw_t
  proposal_z_rows   <- nerf_kernels.py::proposal_z_rows (_sample_kernel_t):
                       the mono path's sampler, proposal sweep to sorted
                       fine z, as (N, S_f) rows (not the TPU's (8, N*S_f))

Each wrapper launches its hand-written CUDA kernel (`csrc/*.cu`, built by
`ops/build.py`) for CUDA tensors and counts the launch in `LAUNCHES`; for
CPU tensors it runs the plain PyTorch version beside it, which repeats
the kernel's arithmetic. There is no fallback from a CUDA tensor.

Precision contract (kept from the JAX package; bounds and design notes
are in each `csrc/*.cu`): bf16 matmul operands with float32
accumulation; activations rounded to bf16 after each ReLU; positions, PE
arguments and sines in float32; outputs pre-activation (compositing in
fine_composite_t applies sigmoid / softplus itself); 1e2 terminal delta.
The TPU layout (features in rows, one-hot expansion matmuls, hi/lo bf16
splits, polynomial sin/exp/log, block-identity transient weights, row
padding) is not carried over: tiles are point-major, point p belongs to
ray p // S, the transient chain runs at its real width W/2 and ragged
edges are masked in-kernel.

Packed weights (`pack_coarse_t`, `pack_fine_t`, `pack_static_t`,
`pack_vanilla_t`): one flat bf16 tensor of (out, in) matrices with in-dims
padded to 16, one flat float32 bias tensor and the PE frequencies, in the
order `_layout` gives (the CUDA code walks the same order). Exact linear algebra of the
JAX pack is kept: xyz_final folds into the [dir | trans_0] layer (w_dt;
the dir half only in the static pack), the per-ray halves of that layer
come in as `per_ray_row` / `per_ray_row_static`, and the skip layer is
split [x0 | h]. The packs are differentiable (casts, cats, transposes,
the fold matmul and slice writes), so gradients of the packed tensors
reach the params tree through autograd.

The vanilla NeRF (NeRFH=False, models/nerf_vanilla.py) packs onto the
static and sigma-only specs (`pack_vanilla_t`): its trunk with the skip one
layer later (`vanilla_skip`), alpha as the sigma row over h, feature folded
into the point half of views_0 as w_dt, the direction half of views_0 as
the per-ray row (`per_ray_row_vanilla`) and rgb as the heads. The kernels
run it unchanged.
"""

from __future__ import annotations

import ctypes
import functools
from fractions import Fraction
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from dfnet_tpu_torch.models.embedder import Embedder
from dfnet_tpu_torch.models.nerf_vanilla import VanillaNeRFConfig
from dfnet_tpu_torch.models.nerfw import NeRFWConfig
from dfnet_tpu_torch.render.sampling import nerfw_deltas, sample_pdf_blend, transmittance

N_RAW = 9      # fine raw rows: rgb 0:3, sigma 3, t-rgb 4:7, t-sigma 7, t-beta 8
N_STATIC = 4   # static raw rows: rgb 0:3, sigma 3
N_COMP = 8     # composite rows: rgb 0:3, acc 3, static depth 4, static rgb 5:8

# launches of each kernel, counted by its wrapper (reset_launches() zeroes)
LAUNCHES = {"coarse_sigma_t": 0, "fine_raw_t": 0, "fine_composite_t": 0,
            "raw_bwd_t": 0, "proposal_z_rows": 0, "mlp_stack_bf16": 0,
            "mlp_stack_int8": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass(frozen=True)
class KernelSpec:
    D: int          # trunk depth
    W: int          # trunk width
    skip: int       # trunk layer taking [x0 | h], -1 for none
    F: int          # PE frequencies
    fine: bool      # full NeRF-W pack
    static: bool = False    # static pack (no transient chain); neither: sigma-only

    def __post_init__(self):
        if self.fine and self.static:
            raise ValueError("a KernelSpec is fine, static or sigma-only")

    @property
    def K0(self) -> int:
        """PE feature count 6F+3, padded to a multiple of 16."""
        return -(-(6 * self.F + 3) // 16) * 16

    @property
    def n_raw(self) -> int:
        """Rows of fine_raw_t's output for this pack."""
        return N_RAW if self.fine else N_STATIC

    @property
    def Wd(self) -> int:
        """Width of the [dir | trans_0] layer and of dpt: W (fine), W/2
        (static: the dir half only)."""
        return self.W if self.fine else self.W // 2


def eff_skip(cfg: NeRFWConfig) -> int:
    return cfg.skips[0] if cfg.skips and cfg.skips[0] < cfg.D else -1


def spec_of(cfg: NeRFWConfig, emb: Embedder, fine: bool,
            static: bool = False) -> KernelSpec:
    return KernelSpec(D=cfg.D, W=cfg.W, skip=eff_skip(cfg),
                      F=emb.num_freqs, fine=fine, static=static)


def _layout(spec: KernelSpec) -> Tuple[List, List]:
    """[(name, shape)] of the packed bf16 weights and float32 biases."""
    W, K0, half = spec.W, spec.K0, spec.W // 2
    ws = [("w0", (W, K0))]
    for i in range(1, spec.D):
        if i == spec.skip:
            ws += [(f"wx{i}", (W, K0)), (f"wh{i}", (W, W))]
        else:
            ws.append((f"w{i}", (W, W)))
    bs = [("b_trunk", (spec.D, W))]
    if spec.fine:
        ws += [("w_dt", (W, W))] + [(f"w_tr{i}", (half, half)) for i in range(3)]
        ws.append(("w_heads", (N_RAW, W)))
        bs += [("b_dt", (W,)), ("b_tr", (3, half)), ("b_heads", (N_RAW,))]
    elif spec.static:
        ws += [("w_dt", (half, W)), ("w_heads", (N_STATIC, W))]
        bs += [("b_dt", (half,)), ("b_heads", (N_STATIC,))]
    else:
        ws.append(("w_sigma", (W,)))
        bs.append(("b_sigma", (1,)))
    return ws, bs


def _flat(parts: Dict, entries, dtype) -> torch.Tensor:
    return torch.cat([parts[n].reshape(-1).to(dtype) for n, _ in entries])


def unpack(packed: Dict, spec: KernelSpec) -> Dict[str, torch.Tensor]:
    """Views of the packed tensors by name (`_layout` order)."""
    out = {}
    for key, entries in zip(("w", "b"), _layout(spec)):
        off = 0
        for name, shape in entries:
            n = int(np.prod(shape))
            out[name] = packed[key][off:off + n].view(shape)
            off += n
    return out


def _pad_cols(w: torch.Tensor, cols: int) -> torch.Tensor:
    return Fn.pad(w, (0, cols - w.shape[1]))


def _pack_trunk(params: Dict, cfg, spec: KernelSpec, prefix: str = "xyz_") -> Dict:
    """The trunk's layers `<prefix>0..D-1`; the skip layer's input rows are
    [x0 | h], x0 first, in both nets."""
    if cfg.in_xyz != 6 * spec.F + 3:
        raise ValueError("kernel PE expects include_input with 6F+3 features")
    f32 = torch.float32
    p = {"w0": _pad_cols(params[f"{prefix}0"]["w"].to(f32).t(), spec.K0)}
    for i in range(1, cfg.D):
        w = params[f"{prefix}{i}"]["w"].to(f32)
        if i == spec.skip:
            p[f"wx{i}"] = _pad_cols(w[:cfg.in_xyz].t(), spec.K0)
            p[f"wh{i}"] = w[cfg.in_xyz:].t()
        else:
            p[f"w{i}"] = w.t()
    p["b_trunk"] = torch.stack([params[f"{prefix}{i}"]["b"].to(f32)
                                for i in range(cfg.D)])
    return p


def _finish(parts: Dict, spec: KernelSpec, emb: Embedder, device) -> Dict:
    ws, bs = _layout(spec)
    return {"w": _flat(parts, ws, torch.bfloat16).contiguous(),
            "b": _flat(parts, bs, torch.float32).contiguous(),
            "freqs": torch.as_tensor(emb.freq_bands, dtype=torch.float32,
                                     device=device).contiguous()}


def pack_coarse_t(params: Dict, cfg: NeRFWConfig, emb: Embedder) -> Dict:
    """Sigma-only pack (proposal or coarse net) for coarse_sigma_t."""
    spec = spec_of(cfg, emb, fine=False)
    parts = _pack_trunk(params, cfg, spec)
    parts["w_sigma"] = params["static_sigma"]["w"][:, 0]
    parts["b_sigma"] = params["static_sigma"]["b"]
    return _finish(parts, spec, emb, params["xyz_0"]["w"].device)


def pack_fine_t(params: Dict, cfg: NeRFWConfig, emb: Embedder) -> Dict:
    """Full NeRF-W pack for fine_raw_t / fine_composite_t."""
    if cfg.out_ch != 3:
        raise ValueError("fused fine kernel supports out_ch=3 only")
    spec = spec_of(cfg, emb, fine=True)
    parts = _pack_trunk(params, cfg, spec)
    f32 = torch.float32
    W, half = cfg.W, cfg.W // 2
    w_final = params["xyz_final"]["w"].to(f32)
    b_final = params["xyz_final"]["b"].to(f32)
    w_dt = torch.cat([params["dir"]["w"].to(f32)[:W],
                      params["trans_0"]["w"].to(f32)[:W]], -1)   # (W, W)
    # dt_pre = h @ (W_final @ w_dt) + b_final @ w_dt (exact fold)
    parts["w_dt"] = (w_final @ w_dt).t()
    parts["b_dt"] = b_final @ w_dt
    for i in range(3):
        parts[f"w_tr{i}"] = params[f"trans_{i + 1}"]["w"].to(f32).t()
    parts["b_tr"] = torch.stack([params[f"trans_{i}"]["b"].to(f32)
                                 for i in (1, 2, 3)])
    heads = w_final.new_zeros((N_RAW, W))
    heads[0:3, :half] = params["static_rgb"]["w"].to(f32).t()
    heads[3] = params["static_sigma"]["w"].to(f32)[:, 0]          # over h
    heads[4:7, half:] = params["trans_rgb"]["w"].to(f32).t()
    heads[7, half:] = params["trans_sigma"]["w"].to(f32)[:, 0]
    heads[8, half:] = params["trans_beta"]["w"].to(f32)[:, 0]
    parts["w_heads"] = heads
    parts["b_heads"] = torch.cat([
        params["static_rgb"]["b"], params["static_sigma"]["b"],
        params["trans_rgb"]["b"], params["trans_sigma"]["b"],
        params["trans_beta"]["b"]]).to(f32)
    return _finish(parts, spec, emb, w_final.device)


def pack_static_t(params: Dict, cfg: NeRFWConfig, emb: Embedder) -> Dict:
    """Static (no-transient) pack for the train-time coarse sweep of
    fine_raw_t: trunk, xyz_final folded into the dir half of the dt
    layer (w_dt is (W/2, W)), rgb head over d and sigma head over h.
    Reference semantics: nerfw_apply_rays(output_transient=False)."""
    if cfg.out_ch != 3:
        raise ValueError("fused static kernel supports out_ch=3 only")
    spec = spec_of(cfg, emb, fine=False, static=True)
    parts = _pack_trunk(params, cfg, spec)
    f32 = torch.float32
    W, half = cfg.W, cfg.W // 2
    w_final = params["xyz_final"]["w"].to(f32)
    wd_h = params["dir"]["w"].to(f32)[:W]                         # (W, half)
    parts["w_dt"] = (w_final @ wd_h).t()
    parts["b_dt"] = params["xyz_final"]["b"].to(f32) @ wd_h
    heads = w_final.new_zeros((N_STATIC, W))
    heads[0:3, :half] = params["static_rgb"]["w"].to(f32).t()
    heads[3] = params["static_sigma"]["w"].to(f32)[:, 0]          # over h
    parts["w_heads"] = heads
    parts["b_heads"] = torch.cat([params["static_rgb"]["b"],
                                  params["static_sigma"]["b"]]).to(f32)
    return _finish(parts, spec, emb, w_final.device)


def per_ray_row_static(params: Dict, cfg: NeRFWConfig, dir_emb):
    """(N, W/2) float32: the per-ray half of the dir layer for the static
    pack (the coarse net has no appearance input), bias folded in."""
    W = cfg.W
    dp = dir_emb @ params["dir"]["w"][W:W + cfg.in_dir] + params["dir"]["b"]
    return dp.float().contiguous()


def per_ray_row(params: Dict, cfg: NeRFWConfig, dir_emb, a_emb, t_emb):
    """(N, W) float32 [dp | tp]: the per-ray halves of the dir and
    transient-0 layers, biases folded in. a/t embeddings may be (1, .)
    (one histogram for the whole batch) and broadcast over the rays."""
    W = cfg.W
    wd = params["dir"]["w"]
    dp = dir_emb @ wd[W:W + cfg.in_dir] + params["dir"]["b"]
    if cfg.encode_appearance and a_emb is not None:
        dp = dp + a_emb @ wd[W + cfg.in_dir:]
    wt = params["trans_0"]["w"]
    tp = t_emb @ wt[W:] + params["trans_0"]["b"]
    n = max(dp.shape[0], tp.shape[0])
    dp = dp.expand(n, dp.shape[1])
    tp = tp.expand(n, tp.shape[1])
    return torch.cat([dp, tp], -1).float().contiguous()


def vanilla_skip(cfg: VanillaNeRFConfig) -> Optional[int]:
    """The kernels' skip layer of a vanilla net, -1 for none, or None where
    no kernel can run its skips. The vanilla net concatenates [x0 | h] AFTER
    layer s's ReLU (s in cfg.skips), so layer s + 1 reads it where NeRF-W's
    layer s would; a concatenation after the last layer would feed the
    heads, and a second one a second skip layer, which the kernels lack."""
    live = [s for s in cfg.skips if s < cfg.D]
    if not live:
        return -1
    if len(live) > 1 or live[0] + 1 >= cfg.D:
        return None
    return live[0] + 1


def vanilla_spec(cfg: VanillaNeRFConfig, emb: Embedder, static: bool = True) -> KernelSpec:
    """The static spec of a vanilla net (fine_raw_t, raw_bwd_t), or its
    sigma-only spec (coarse_sigma_t)."""
    skip = vanilla_skip(cfg)
    if skip is None:
        raise ValueError(f"no kernel runs the vanilla skips {cfg.skips} at D={cfg.D}")
    return KernelSpec(D=cfg.D, W=cfg.W, skip=skip, F=emb.num_freqs, fine=False,
                      static=static)


def pack_vanilla_t(params: Dict, cfg: VanillaNeRFConfig, emb: Embedder,
                   sigma_only: bool = False) -> Dict:
    """A vanilla net (models/nerf_vanilla.py, with viewdirs) on the static
    pack: its trunk, feature folded into the point half of views_0 (w_dt
    is (W/2, W), exact as pack_static_t's fold), rgb over d and alpha over h
    as the heads; with sigma_only, the trunk and alpha for coarse_sigma_t.
    Reference semantics: nerf_apply_rays."""
    if not cfg.use_viewdirs:
        raise ValueError("the kernels run a vanilla net with viewdirs only")
    spec = vanilla_spec(cfg, emb, static=not sigma_only)
    parts = _pack_trunk(params, cfg, spec, prefix="pts_")
    f32 = torch.float32
    alpha = params["alpha"]["w"].to(f32)[:, 0]
    if sigma_only:
        parts["w_sigma"] = alpha
        parts["b_sigma"] = params["alpha"]["b"]
        return _finish(parts, spec, emb, alpha.device)
    W, half = cfg.W, cfg.W // 2
    w_feat = params["feature"]["w"].to(f32)
    wv_h = params["views_0"]["w"].to(f32)[:W]                    # (W, half)
    parts["w_dt"] = (w_feat @ wv_h).t()
    parts["b_dt"] = params["feature"]["b"].to(f32) @ wv_h
    heads = w_feat.new_zeros((N_STATIC, W))
    heads[0:3, :half] = params["rgb"]["w"].to(f32).t()
    heads[3] = alpha                                              # over h
    parts["w_heads"] = heads
    parts["b_heads"] = torch.cat([params["rgb"]["b"], params["alpha"]["b"]]).to(f32)
    return _finish(parts, spec, emb, alpha.device)


def per_ray_row_vanilla(params: Dict, cfg: VanillaNeRFConfig, dir_emb):
    """(N, W/2) float32: the direction half of a vanilla net's views_0,
    bias folded in, for its static pack."""
    dp = dir_emb @ params["views_0"]["w"][cfg.W:] + params["views_0"]["b"]
    return dp.float().contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernels' arithmetic, one tensor op at a time)
# ---------------------------------------------------------------------------

def _bf(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back (an operand of a bf16 matmul)."""
    return x.bfloat16().float()


def _pe_plain(pts: torch.Tensor, freqs: torch.Tensor, K0: int) -> torch.Tensor:
    """(P, 3) float32 -> (P, K0) bf16-valued [xyz, sin f0, cos f0, ...]."""
    xb = pts[:, None, :] * freqs[:, None]                      # (P, F, 3)
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], -2).reshape(pts.shape[0], -1)
    x0 = torch.cat([pts, enc], -1)
    return _bf(Fn.pad(x0, (0, K0 - x0.shape[1])))


def _trunk_plain(v: Dict, spec: KernelSpec, x0: torch.Tensor) -> torch.Tensor:
    b = v["b_trunk"]
    h = _bf(torch.relu(x0 @ v["w0"].float().t() + b[0]))
    for i in range(1, spec.D):
        if i == spec.skip:
            y = x0 @ v[f"wx{i}"].float().t() + h @ v[f"wh{i}"].float().t()
        else:
            y = h @ v[f"w{i}"].float().t()
        h = _bf(torch.relu(y + b[i]))
    return h


def _uniform_z(S: int, near: float, far: float, lindisp: bool, device):
    t = torch.arange(S, device=device, dtype=torch.float32) * float(
        np.float32(1.0 / (S - 1)))
    if lindisp:
        return 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    return near * (1.0 - t) + far * t


def coarse_sigma_plain(packed: Dict, rays_o, rays_d, spec: KernelSpec, S: int,
                       near: float, far: float, lindisp: bool = False):
    """Plain version of coarse_sigma_t: (N, S) float32 pre-softplus sigma."""
    v = unpack(packed, spec)
    z = _uniform_z(S, near, far, lindisp, rays_o.device)
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[None, :, None]).reshape(-1, 3)
    h = _trunk_plain(v, spec, _pe_plain(pts, packed["freqs"], spec.K0))
    sig = h @ v["w_sigma"].float() + v["b_sigma"]
    return sig.reshape(rays_o.shape[0], S)


def _points(rays_o, rays_d, z_all) -> torch.Tensor:
    return (rays_o[:, None, :] + rays_d[:, None, :] * z_all[..., None]).reshape(-1, 3)


def fine_raw_plain(packed: Dict, rays_o, rays_d, z_all, dpt, spec: KernelSpec):
    """Plain version of fine_raw_t: (9, N, S) float32 pre-activation rows
    for the fine pack, (4, N, S) [rgb, sigma] for the static pack."""
    v = unpack(packed, spec)
    N, S = z_all.shape
    half = spec.W // 2
    h = _trunk_plain(v, spec, _pe_plain(_points(rays_o, rays_d, z_all),
                                        packed["freqs"], spec.K0))
    heads, bh = v["w_heads"].float(), v["b_heads"]
    sigma = h @ heads[3] + bh[3]
    pre = (h @ v["w_dt"].float().t()).reshape(N, S, -1) + v["b_dt"] + dpt[:, None, :]
    dt = _bf(torch.relu(pre)).reshape(N * S, -1)
    d = dt[:, :half]
    rgb = d @ heads[0:3, :half].t() + bh[0:3]
    if not spec.fine:
        raw = torch.cat([rgb, sigma[:, None]], -1)             # (N*S, 4)
        return raw.t().reshape(N_STATIC, N, S).contiguous()
    t = dt[:, half:]
    for i in range(3):
        t = _bf(torch.relu(t @ v[f"w_tr{i}"].float().t() + v["b_tr"][i]))
    trans = t @ heads[4:9, half:].t() + bh[4:9]
    raw = torch.cat([rgb, sigma[:, None], trans], -1)          # (N*S, 9)
    return raw.t().reshape(N_RAW, N, S).contiguous()


BWD_TILE = 64       # points per tile of bwd_stash; the stash's rows pad to it
BWD_G_RAW = 16      # columns of the stash's g_raw region
# columns of a row of bwd_problems (csrc/raw_bwd.cu reads them by these names)
BWD_PROBLEM_COLS = ("g_off", "g_ld", "g_col", "a_off", "a_ld", "a_col", "M", "K", "r0",
                    "r1", "w_off", "w_ld", "b_off")


def bwd_regions(spec: KernelSpec) -> List[Tuple[str, int]]:
    """(name, width) of each region of raw_bwd_t's stash, in the order the
    CUDA code indexes them (csrc/raw_bwd.cu, R_*): the input activations A_l
    x0, h0..h{D-1}, dt0 (= [d | t0]), t1..t3, then the masked output
    cotangents G_l g_h0..g_h{D-1}, g_dt, g_t1..g_t3, and g_raw (g rounded to
    bf16, zero-padded to 16 columns). The static pack's t and g_t regions
    have width 0."""
    D, W, Wd = spec.D, spec.W, spec.Wd
    tw = spec.W // 2 if spec.fine else 0
    return ([("x0", spec.K0)] + [(f"h{i}", W) for i in range(D)] + [("dt0", Wd)]
            + [(f"t{i}", tw) for i in (1, 2, 3)]
            + [(f"g_h{i}", W) for i in range(D)] + [("g_dt", Wd)]
            + [(f"g_t{i}", tw) for i in (1, 2, 3)] + [("g_raw", BWD_G_RAW)])


def bwd_points(N: int, S: int) -> int:
    """Rows of raw_bwd_t's stash: N*S rounded up to a whole tile."""
    return -(-N * S // BWD_TILE) * BWD_TILE


def bwd_stash_offsets(spec: KernelSpec, Pp: int) -> Dict[str, Tuple[int, int]]:
    """{region: (offset in elements, width)}; each region is (Pp, width)."""
    out, off = {}, 0
    for name, width in bwd_regions(spec):
        out[name] = (off, width)
        off += Pp * width
    out["total"] = (off, 0)
    return out


def bwd_stash_views(stash: torch.Tensor, spec: KernelSpec, N: int,
                    S: int) -> Dict[str, torch.Tensor]:
    """{region: (N*S, width) view of its live rows} of a stash."""
    R = bwd_stash_offsets(spec, bwd_points(N, S))
    return {name: stash[R[name][0]:R[name][0] + N * S * width].view(N * S, width)
            for name, width in bwd_regions(spec) if width}


def _packed_offsets(entries) -> Dict[str, int]:
    out, off = {}, 0
    for name, shape in entries:
        out[name] = off
        off += int(np.prod(shape))
    return out


def bwd_problems(spec: KernelSpec, Pp: int) -> List[List[int]]:
    """The weight-grad GEMMs of raw_bwd_t, one row (BWD_PROBLEM_COLS) each:
    dW[r, c] = sum_p G[p, g_col + r] A[p, a_col + c] for r < M, c < K, kept
    for r0 <= r < r1 at w_off + r * w_ld + c of the packed weights; and,
    where b_off >= 0, db[b_off + r] = sum_p G[p, g_col + r]. G and A are
    stash regions (offset, row length). Shared by the wrapper (the table
    bwd_wgrad reads) and raw_bwd_from_stash_plain."""
    R = bwd_stash_offsets(spec, Pp)
    ws, bs = _layout(spec)
    wo, bo = _packed_offsets(ws), _packed_offsets(bs)
    D, W, K0, half, Wd = spec.D, spec.W, spec.K0, spec.W // 2, spec.Wd

    def prob(g, a, a_col, M, K, w_off, w_ld, b_off, r0=0, r1=None):
        return [*R[g], 0, R[a][0], R[a][1], a_col, M, K, r0, M if r1 is None else r1,
                w_off, w_ld, b_off]

    bt = bo["b_trunk"]
    probs = [prob("g_h0", "x0", 0, W, K0, wo["w0"], K0, bt)]
    for i in range(1, D):
        if i == spec.skip:
            probs += [prob(f"g_h{i}", "x0", 0, W, K0, wo[f"wx{i}"], K0, bt + i * W),
                      prob(f"g_h{i}", f"h{i - 1}", 0, W, W, wo[f"wh{i}"], W, -1)]
        else:
            probs.append(prob(f"g_h{i}", f"h{i - 1}", 0, W, W, wo[f"w{i}"], W, bt + i * W))
    probs.append(prob("g_dt", f"h{D - 1}", 0, Wd, W, wo["w_dt"], W, bo["b_dt"]))
    if spec.fine:
        for i in range(3):
            a, a_col = ("dt0", half) if i == 0 else (f"t{i}", 0)
            probs.append(prob(f"g_t{i + 1}", a, a_col, half, half, wo[f"w_tr{i}"], half,
                              bo["b_tr"] + i * half))
    # heads: rgb rows 0:3 over d, sigma row 3 over h, transient rows 4:9 over t3
    wh, bh = wo["w_heads"], bo["b_heads"]
    probs += [prob("g_raw", "dt0", 0, BWD_G_RAW, half, wh, W, bh, 0, 3),
              prob("g_raw", f"h{D - 1}", 0, BWD_G_RAW, W, wh, W, bh, 3, 4)]
    if spec.fine:
        probs.append(prob("g_raw", "t3", 0, BWD_G_RAW, half, wh + half, W, bh, 4, N_RAW))
    return probs


def bwd_jobs(problems: List[List[int]], tile: int = 128) -> List[Tuple[int, int, int]]:
    """(problem, m0, n0) of each output tile of bwd_wgrad (its WG_BM x WG_BN,
    128 x 128)."""
    M, K = BWD_PROBLEM_COLS.index("M"), BWD_PROBLEM_COLS.index("K")
    return [(i, m0, n0) for i, p in enumerate(problems)
            for m0 in range(0, p[M], tile) for n0 in range(0, p[K], tile)]


def bwd_chunks(Pp: int, n_jobs: int, n_sm: int) -> Tuple[int, int]:
    """(chunk, n_chunks): the split of the stash's rows among bwd_wgrad's
    blocks, about four blocks an SM (two run at a time), each chunk a whole
    number of tiles."""
    n = max(1, min(-(-4 * n_sm // n_jobs), Pp // 1024))
    chunk = max(BWD_TILE, -(-Pp // (n * BWD_TILE)) * BWD_TILE)
    return chunk, -(-Pp // chunk)


def _bwd_chain_plain(packed: Dict, rays_o, rays_d, z_all, dpt, g, spec: KernelSpec):
    """raw_bwd_t's recompute and cotangent chain in plain torch:
    {bwd_regions name: (N*S, width) float32 tensor of bf16 values}."""
    v = unpack(packed, spec)
    N, S = z_all.shape
    P, half, Wd = N * S, spec.W // 2, spec.Wd
    wf = {k: t.float() for k, t in v.items()}
    # forward recompute, stashing the post-ReLU activations (bf16 values)
    x0 = _pe_plain(_points(rays_o, rays_d, z_all), packed["freqs"], spec.K0)
    b = v["b_trunk"]
    hs = [_bf(torch.relu(x0 @ wf["w0"].t() + b[0]))]
    for i in range(1, spec.D):
        if i == spec.skip:
            y = x0 @ wf[f"wx{i}"].t() + hs[-1] @ wf[f"wh{i}"].t()
        else:
            y = hs[-1] @ wf[f"w{i}"].t()
        hs.append(_bf(torch.relu(y + b[i])))
    pre = (hs[-1] @ wf["w_dt"].t()).reshape(N, S, Wd) + v["b_dt"] + dpt[:, None, :]
    dt0 = _bf(torch.relu(pre)).reshape(P, Wd)
    ts = []
    if spec.fine:
        ts = [dt0[:, half:]]
        for i in range(3):
            ts.append(_bf(torch.relu(ts[-1] @ wf[f"w_tr{i}"].t() + v["b_tr"][i])))

    def masked(act, gr):
        return _bf(torch.where(act > 0, gr, torch.zeros_like(gr)))

    heads = wf["w_heads"]
    gb = _bf(g.reshape(spec.n_raw, P).t())                    # (P, n_raw)
    out = {"x0": x0, "dt0": dt0, "g_raw": Fn.pad(gb, (0, BWD_G_RAW - spec.n_raw))}
    out.update({f"h{i}": h for i, h in enumerate(hs)})
    g0 = masked(dt0[:, :half], gb[:, 0:3] @ heads[0:3, :half])
    if spec.fine:
        out.update({f"t{i}": ts[i] for i in (1, 2, 3)})
        gt = gb[:, 4:9] @ heads[4:9, half:]
        for i in (2, 1, 0):
            gp = masked(ts[i + 1], gt)
            out[f"g_t{i + 1}"] = gp
            gt = gp @ wf[f"w_tr{i}"]
        g0 = torch.cat([g0, masked(ts[0], gt)], -1)
    out["g_dt"] = g0
    g_h = g0 @ wf["w_dt"] + gb[:, 3:4] * heads[3][None]
    for i in range(spec.D - 1, -1, -1):
        gp = masked(hs[i], g_h)
        out[f"g_h{i}"] = gp
        if i > 0:
            g_h = gp @ wf[f"wh{i}" if i == spec.skip else f"w{i}"]
    return out


def raw_bwd_plain(packed: Dict, rays_o, rays_d, z_all, dpt, g, spec: KernelSpec):
    """Plain version of raw_bwd_t, the backward of fine_raw_t (fine or
    static pack) for the cotangent g (n_raw, N, S) of its output:
    returns (d_w (bf16, packed["w"]'s layout), d_b (float32, packed["b"]'s
    layout), d_dpt (N, Wd) float32). Rays, z and freqs get none.

    Precision contract of the JAX kernel (_bwd_kernel_t): g is rounded to
    bf16 before the heads' weight and bias grads and their input grads;
    each later cotangent is masked by its stashed activation > 0 and
    rounded to bf16 before it becomes a matmul operand; every product
    sums in float32; weight grads leave as bf16."""
    t = _bwd_chain_plain(packed, rays_o, rays_d, z_all, dpt, g, spec)
    v = unpack(packed, spec)
    N, S = z_all.shape
    half, n_raw = spec.W // 2, spec.n_raw
    gb, h = t["g_raw"][:, :n_raw], t[f"h{spec.D - 1}"]
    grads = {"w_heads": torch.zeros_like(v["w_heads"], dtype=torch.float32)}
    grads["w_heads"][0:3, :half] = gb[:, 0:3].t() @ t["dt0"][:, :half]
    grads["w_heads"][3] = gb[:, 3] @ h
    if spec.fine:
        grads["w_heads"][4:9, half:] = gb[:, 4:9].t() @ t["t3"]
        grads["b_tr"] = torch.stack([t[f"g_t{i + 1}"].sum(0) for i in range(3)])
        for i in range(3):
            a = t["dt0"][:, half:] if i == 0 else t[f"t{i}"]
            grads[f"w_tr{i}"] = t[f"g_t{i + 1}"].t() @ a
    grads["b_heads"] = gb.sum(0)
    g0 = t["g_dt"]
    grads["w_dt"] = g0.t() @ h
    grads["b_dt"] = g0.sum(0)
    d_dpt = g0.reshape(N, S, spec.Wd).sum(1)
    grads["b_trunk"] = torch.stack([t[f"g_h{i}"].sum(0) for i in range(spec.D)])
    grads["w0"] = t["g_h0"].t() @ t["x0"]
    for i in range(1, spec.D):
        gp, a = t[f"g_h{i}"], t[f"h{i - 1}"]
        if i == spec.skip:
            grads[f"wx{i}"] = gp.t() @ t["x0"]
            grads[f"wh{i}"] = gp.t() @ a
        else:
            grads[f"w{i}"] = gp.t() @ a
    ws, bs = _layout(spec)
    return (_flat(grads, ws, torch.bfloat16), _flat(grads, bs, torch.float32),
            d_dpt)


def raw_bwd_stash_plain(packed: Dict, rays_o, rays_d, z_all, dpt, g,
                        spec: KernelSpec) -> torch.Tensor:
    """Plain version of bwd_stash, raw_bwd_t's first launch: the flat bf16
    stash, bwd_stash_offsets' layout, rows N*S..Pp zero."""
    t = _bwd_chain_plain(packed, rays_o, rays_d, z_all, dpt, g, spec)
    N, S = z_all.shape
    R = bwd_stash_offsets(spec, bwd_points(N, S))
    stash = torch.zeros(R["total"][0], dtype=torch.bfloat16, device=rays_o.device)
    for name, width in bwd_regions(spec):
        if width:
            off = R[name][0]
            stash[off:off + N * S * width] = t[name].reshape(-1).bfloat16()
    return stash


def bwd_problem_views(stash: torch.Tensor, spec: KernelSpec, N: int, S: int):
    """[(G (Pp, M), A (Pp, K), problem row)] for each row of bwd_problems:
    the two operands of its GEMM as views of the stash, over all Pp rows."""
    Pp = bwd_points(N, S)

    def cols(off, ld, col, n):
        return stash[off:off + Pp * ld].view(Pp, ld)[:, col:col + n]

    return [(cols(go, gld, gcol, M), cols(ao, ald, acol, K), row)
            for row in bwd_problems(spec, Pp)
            for go, gld, gcol, ao, ald, acol, M, K, *_ in [row]]


def raw_bwd_from_stash_plain(stash: torch.Tensor, spec: KernelSpec, N: int, S: int):
    """Plain version of bwd_wgrad + bwd_reduce: every problem of
    bwd_problems as one float32 torch.matmul over all the stash's rows,
    assembled into (d_w bf16, d_b float32, d_dpt (N, Wd) float32)."""
    ws, bs = _layout(spec)
    nw = sum(int(np.prod(s)) for _, s in ws)
    nb = sum(int(np.prod(s)) for _, s in bs)
    dw = torch.zeros(nw, dtype=torch.float32, device=stash.device)
    db = torch.zeros(nb, dtype=torch.float32, device=stash.device)
    s = stash.float()
    for G, A, (*_, K, r0, r1, w_off, w_ld, b_off) in bwd_problem_views(s, spec, N, S):
        torch.as_strided(dw, (r1 - r0, K), (w_ld, 1), w_off + r0 * w_ld).copy_(
            (G.t() @ A)[r0:r1])
        if b_off >= 0:
            db[b_off + r0:b_off + r1] = G[:, r0:r1].sum(0)
    d_dpt = bwd_stash_views(s, spec, N, S)["g_dt"].reshape(N, S, spec.Wd).sum(1)
    return dw.bfloat16(), db, d_dpt


def _composite_plain(raw: torch.Tensor, z_all: torch.Tensor) -> torch.Tensor:
    """(9, N, S) pre-activation rows + z -> (8, N) per-ray sums."""
    srgb = torch.sigmoid(raw[0:3])
    ssig = Fn.softplus(raw[3])
    trgb = torch.sigmoid(raw[4:7])
    tsig = Fn.softplus(raw[7])
    dz = nerfw_deltas(z_all)
    sa = 1.0 - torch.exp(-dz * ssig)
    ta = 1.0 - torch.exp(-dz * tsig)
    al = 1.0 - torch.exp(-dz * (ssig + tsig))
    trans = transmittance(al)
    s_trans = transmittance(sa)
    sw, tw, swo = sa * trans, ta * trans, sa * s_trans
    rgb = (sw * srgb + tw * trgb).sum(-1)
    return torch.cat([rgb, (al * trans).sum(-1)[None],
                      (swo * z_all).sum(-1)[None], (swo * srgb).sum(-1)], 0)


def fine_composite_plain(packed: Dict, rays_o, rays_d, z_all, dpt,
                         spec: KernelSpec):
    """Plain version of fine_composite_t: (8, N) float32."""
    raw = fine_raw_plain(packed, rays_o, rays_d, z_all, dpt, spec)
    return _composite_plain(raw, z_all)


def proposal_z_plain(packed: Dict, rays_o, rays_d, spec: KernelSpec, S: int,
                     S_f: int, near: float, far: float, lam: float):
    """Plain version of proposal_z_rows: the sigma sweep at S uniform z,
    softplus, composite weights (1e2 terminal delta) and the blended-CDF
    draw of render/sampling.py::sample_pdf_blend -> (N, S_f) sorted z."""
    sigma = Fn.softplus(coarse_sigma_plain(packed, rays_o, rays_d, spec, S, near, far))
    return proposal_z_from_sigma(sigma, S_f, near, far, lam)


def proposal_z_from_sigma(sigma: torch.Tensor, S_f: int, near: float, far: float,
                          lam: float) -> torch.Tensor:
    """proposal_z_plain after the sweep: (N, S) softplus(sigma) at the S
    uniform z -> (N, S_f) sorted z."""
    N, S = sigma.shape
    z = _uniform_z(S, near, far, False, sigma.device).expand(N, S)
    alphas = 1.0 - torch.exp(-nerfw_deltas(z) * sigma)
    weights = alphas * transmittance(alphas)
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    return sample_pdf_blend(z_mid, weights[:, 1:-1], S_f, lam).contiguous()


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"unsupported device {t.device}")


def _check(name: str, t: torch.Tensor, shape, dtype, device):
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def _check_common(packed: Dict, spec: KernelSpec, rays_o, rays_d, S: int):
    dev = rays_o.device
    N = rays_o.shape[0]
    if spec.W % 32 or spec.D < 1 or not (spec.skip == -1 or 1 <= spec.skip < spec.D):
        raise ValueError(f"kernel needs W % 32 == 0 and a skip in [1, D): {spec}")
    if S < 2 or N * S >= 2 ** 31:
        raise ValueError(f"bad sweep size N={N} S={S}")
    ws, bs = _layout(spec)
    _check("rays_o", rays_o, (N, 3), torch.float32, dev)
    _check("rays_d", rays_d, (N, 3), torch.float32, dev)
    _check("packed w", packed["w"], (sum(int(np.prod(s)) for _, s in ws),),
           torch.bfloat16, dev)
    _check("packed b", packed["b"], (sum(int(np.prod(s)) for _, s in bs),),
           torch.float32, dev)
    _check("freqs", packed["freqs"], (spec.F,), torch.float32, dev)


def _check_aligned16(name: str, *tensors: torch.Tensor):
    """The panel kernels read dpt and the biases 16 bytes at a time."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} reads dpt and the biases 16 bytes at a time: "
                         "they must start 16-byte aligned")


def _check_tma(name: str, w: torch.Tensor):
    if w.data_ptr() % 16:
        raise ValueError(f"{name} loads the packed weights by TMA: they must start "
                         "16-byte aligned")


def _check_width(name: str, spec: KernelSpec):
    if spec.W > 256:
        raise ValueError(f"{name} takes W <= 256: {spec}")


def _occupancy(source: str, *args: int) -> Tuple[int, int]:
    """(blocks an SM, shared memory bytes a block) from the occupancy entry
    point dfn_<source>_occupancy(*args, &blocks, &smem)."""
    from dfnet_tpu_torch.ops import build

    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    _raise_on(build.load(source, f"dfn_{source}_occupancy")(
        *args, ctypes.addressof(blocks), ctypes.addressof(smem)), f"{source}_occupancy")
    return blocks.value, smem.value


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def coarse_sigma_t(packed: Dict, rays_o, rays_d, spec: KernelSpec, S: int,
                   near: float, far: float, lindisp: bool = False) -> torch.Tensor:
    """Sigma-only sweep over in-kernel uniform z samples:
    rays (N,3)x2 -> (N, S) float32 PRE-softplus sigma."""
    if not _on_cuda(rays_o):
        return coarse_sigma_plain(packed, rays_o, rays_d, spec, S, near, far,
                                  lindisp)
    from dfnet_tpu_torch.ops import build

    if spec.fine or spec.static:
        raise ValueError("coarse_sigma_t takes a sigma-only pack")
    _check_width("coarse_sigma_t", spec)
    _check_common(packed, spec, rays_o, rays_d, S)
    _check_aligned16("coarse_sigma_t", packed["b"])
    N = rays_o.shape[0]
    out = torch.empty((N, S), device=rays_o.device, dtype=torch.float32)
    if N == 0:
        return out
    fn = build.load("coarse_sigma")
    rc = fn(rays_o.data_ptr(), rays_d.data_ptr(), N, S, float(near), float(far),
            float(np.float32(1.0 / (S - 1))), int(bool(lindisp)),
            packed["w"].data_ptr(), packed["b"].data_ptr(),
            packed["freqs"].data_ptr(), spec.D, spec.W, spec.skip, spec.F,
            out.data_ptr(), _stream(out))
    _raise_on(rc, "coarse_sigma_t")
    LAUNCHES["coarse_sigma_t"] += 1
    return out


def coarse_sigma_occupancy(W: int, F: int) -> Tuple[int, int]:
    """(blocks an SM, shared memory bytes a block) of the coarse_sigma_t
    kernel that width W runs, from the CUDA occupancy calculator."""
    return _occupancy("coarse_sigma", W, F)


def _fine_args(packed, spec: KernelSpec, rays_o, rays_d, z_all, dpt):
    """Checks of the fine-sweep kernels' inputs; their common arguments."""
    N, S = z_all.shape
    _check_common(packed, spec, rays_o, rays_d, S)
    _check("z_all", z_all, (N, S), torch.float32, rays_o.device)
    _check("dpt", dpt, (N, spec.Wd), torch.float32, rays_o.device)
    return (rays_o.data_ptr(), rays_d.data_ptr(), z_all.data_ptr(),
            dpt.data_ptr(), N, S, packed["w"].data_ptr(), packed["b"].data_ptr(),
            packed["freqs"].data_ptr(), spec.D, spec.W, spec.skip, spec.F)


def fine_raw_t(packed: Dict, rays_o, rays_d, z_all, dpt,
               spec: KernelSpec) -> torch.Tensor:
    """MLP sweep at given z: rays (N,3)x2, sorted z (N,S), per-ray rows dpt
    (N, spec.Wd) -> PRE-activation rows, (9, N, S) [rgb, sigma, t-rgb,
    t-sigma, t-beta] for the fine pack, (4, N, S) [rgb, sigma] for the
    static pack."""
    if not _on_cuda(rays_o):
        return fine_raw_plain(packed, rays_o, rays_d, z_all, dpt, spec)
    from dfnet_tpu_torch.ops import build

    if not (spec.fine or spec.static):
        raise ValueError("fine_raw_t takes a fine or a static pack")
    _check_width("fine_raw_t", spec)
    N, S = z_all.shape
    out = torch.empty((spec.n_raw, N, S), device=rays_o.device, dtype=torch.float32)
    args = _fine_args(packed, spec, rays_o, rays_d, z_all, dpt)
    _check_aligned16("fine_raw_t", dpt, packed["b"])
    _check_tma("fine_raw_t", packed["w"])
    if N == 0:
        return out
    rc = build.load("fine_raw")(*args, int(spec.static), out.data_ptr(), _stream(out))
    _raise_on(rc, "fine_raw_t")
    LAUNCHES["fine_raw_t"] += 1
    return out


def fine_raw_occupancy(W: int, F: int) -> Tuple[int, int]:
    """(blocks an SM, shared memory bytes a block) of the fine_raw_t
    kernel that width W runs, its fine pack at the most consumer warpgroups
    (the block a large sweep takes), from the CUDA occupancy calculator."""
    return _occupancy("fine_raw", W, F)


# The panel kernels' shared memory (csrc/sweep.cuh::fwd_layout), mirrored so
# that fine_composite_t's geometry can be checked without a card.
SWEEP_TILE = 64              # points a tile (sweep.cuh TP)
COMP_MAX_POINTS = 256        # fine_composite_t's R*S when a block holds more than a ray


def _align128(x: int) -> int:
    return -(-x // 128) * 128


def sweep_smem_bytes(W: int, F: int) -> int:
    """Shared bytes a block of csrc/sweep.cuh::fwd_layout (bf16 tiles padded
    by 8 columns, 8 warps, head-output rows of 20 floats)."""
    K0, b, f = -(-(6 * F + 3) // 16) * 16, 2, 4
    panel = max(W * (64 + 8), 64 * (W + 8))
    parts = [SWEEP_TILE * (K0 + 8) * b, SWEEP_TILE * (W + 8) * b, SWEEP_TILE * (W + 8) * b,
             panel * b, panel * b, 8 * 256 * f, 16 * (2 * W + 8) * b,
             SWEEP_TILE * 20 * f, SWEEP_TILE * 3 * f, SWEEP_TILE * f, SWEEP_TILE * 4]
    return sum(_align128(p) for p in parts)


def _block_rows(R: int, S: int) -> int:
    """Rows of the 64-row sub-tiles that R rays of S samples fill."""
    return -(-R * S // SWEEP_TILE) * SWEEP_TILE


def fine_composite_geometry(S: int) -> Tuple[int, int]:
    """(R, sub-tiles) of fine_composite_t at S samples a ray: a block owns R
    whole rays and runs their R*S points through ceil(R*S/64) sub-tiles of
    64 rows. R keeps R*S <= COMP_MAX_POINTS (R = 1 where S is larger), so
    that the composite buffer beside the panels leaves two blocks an SM at
    W <= 128; among those R, the fewest tile rows a ray, then the least R."""
    R = min(range(1, max(1, COMP_MAX_POINTS // S) + 1),
            key=lambda r: (Fraction(_block_rows(r, S), r), r))
    return R, _block_rows(R, S) // SWEEP_TILE


def fine_composite_smem_bytes(W: int, F: int, S: int) -> int:
    """Shared bytes a block of fine_composite_t: the sweep's, then the z and
    the 8 composite inputs (float32) of the block's R*S points."""
    R, _ = fine_composite_geometry(S)
    return sweep_smem_bytes(W, F) + _align128((1 + N_COMP) * R * S * 4)


def fine_composite_occupancy(W: int, F: int, S: int) -> Tuple[int, int, int]:
    """(blocks an SM, shared memory bytes a block, R rays a block) of the
    fine_composite_t kernel at width W and S samples a ray."""
    R, _ = fine_composite_geometry(S)
    return (*_occupancy("fine_composite", W, F, S, R), R)


def fine_composite_t(packed: Dict, rays_o, rays_d, z_all, dpt,
                     spec: KernelSpec) -> torch.Tensor:
    """Fine sweep + test-time NeRF-W compositing: -> (8, N) float32
    [rgb 0:3, acc 3, static depth 4, static rgb 5:8]."""
    if not _on_cuda(rays_o):
        return fine_composite_plain(packed, rays_o, rays_d, z_all, dpt, spec)
    from dfnet_tpu_torch.ops import build

    if not spec.fine:
        raise ValueError("fine_composite_t takes a fine pack")
    _check_width("fine_composite_t", spec)
    N, S = z_all.shape
    out = torch.empty((N_COMP, N), device=rays_o.device, dtype=torch.float32)
    args = _fine_args(packed, spec, rays_o, rays_d, z_all, dpt)
    _check_aligned16("fine_composite_t", dpt, packed["b"])
    if N == 0:
        return out
    R, _ = fine_composite_geometry(S)
    rc = build.load("fine_composite")(*args, R, out.data_ptr(), _stream(out))
    _raise_on(rc, "fine_composite_t")
    LAUNCHES["fine_composite_t"] += 1
    return out


def proposal_z_geometry(S: int) -> Tuple[int, int]:
    """(R, sub-tiles) of proposal_z_rows at S samples a ray: a block owns R
    whole rays and runs their R*S points through ceil(R*S/64) sub-tiles of
    64 rows. Among the R with R*S <= COMP_MAX_POINTS (R = 1 where S is
    larger), the fewest tile rows a ray, then the MOST rays: a block's
    fixed cost (the head's staging, the scans' barriers) is then shared by
    more rays (at S=64, R=4 took 13-15% off R=1 on the card; PERF.md)."""
    R = min(range(1, max(1, COMP_MAX_POINTS // S) + 1),
            key=lambda r: (Fraction(_block_rows(r, S), r), -r))
    return R, _block_rows(R, S) // SWEEP_TILE


def proposal_z_smem_bytes(W: int, F: int, S: int) -> int:
    """Shared bytes a block of proposal_z_rows: the sweep's, then one float
    (softplus sigma, then the CDF edge) of each of the block's R*S points."""
    R, _ = proposal_z_geometry(S)
    return sweep_smem_bytes(W, F) + _align128(R * S * 4)


def proposal_z_occupancy(W: int, F: int, S: int) -> Tuple[int, int, int]:
    """(blocks an SM, shared memory bytes a block, R rays a block) of the
    proposal_z_rows kernel at width W and S samples a ray."""
    R, _ = proposal_z_geometry(S)
    return (*_occupancy("proposal_z", W, F, S, R), R)


def proposal_z_rows(packed: Dict, rays_o, rays_d, spec: KernelSpec, S: int,
                    S_f: int, near: float, far: float, lam: float) -> torch.Tensor:
    """The mono path's sampler: the sigma-only (proposal) sweep at S
    uniform z (linear in depth), its composite weights and the inverse of
    the blended CDF (1-lam) cdf + lam uniform at S_f evenly spaced u ->
    (N, S_f) float32 SORTED fine z, fine_composite_t's z input."""
    if not _on_cuda(rays_o):
        return proposal_z_plain(packed, rays_o, rays_d, spec, S, S_f, near, far, lam)
    from dfnet_tpu_torch.ops import build

    if spec.fine or spec.static:
        raise ValueError("proposal_z_rows takes a sigma-only pack")
    _check_width("proposal_z_rows", spec)
    N = rays_o.shape[0]
    if S < 3 or S_f < 2 or N * S_f >= 2 ** 31:
        raise ValueError(f"bad sampler size N={N} S={S} S_f={S_f}")
    _check_common(packed, spec, rays_o, rays_d, S)
    _check_aligned16("proposal_z_rows", packed["b"])
    out = torch.empty((N, S_f), device=rays_o.device, dtype=torch.float32)
    if N == 0:
        return out
    R, _ = proposal_z_geometry(S)
    rc = build.load("proposal_z")(
        rays_o.data_ptr(), rays_d.data_ptr(), N, S, S_f, float(near), float(far),
        float(np.float32(1.0 / (S - 1))), float(np.float32(1.0 / (S_f - 1))),
        float(np.float32((far - near) / (S - 1))), float(lam),
        packed["w"].data_ptr(), packed["b"].data_ptr(), packed["freqs"].data_ptr(),
        spec.D, spec.W, spec.skip, spec.F, R, out.data_ptr(), _stream(out))
    _raise_on(rc, "proposal_z_rows")
    LAUNCHES["proposal_z_rows"] += 1
    return out


@functools.lru_cache(maxsize=16)
def _bwd_tables(spec: KernelSpec, Pp: int, device: torch.device):
    """bwd_wgrad's problem and job tables on the device, and its split."""
    probs = bwd_problems(spec, Pp)
    jobs = bwd_jobs(probs)
    chunk, n_chunks = bwd_chunks(Pp, len(jobs),
                                 torch.cuda.get_device_properties(device).multi_processor_count)
    return (torch.tensor(probs, dtype=torch.int64, device=device),
            torch.tensor(jobs, dtype=torch.int32, device=device), len(jobs), chunk,
            n_chunks)


def raw_bwd_launches(packed: Dict, rays_o, rays_d, z_all, dpt, g, spec: KernelSpec):
    """raw_bwd_t's three launches on CUDA tensors, checked and allocated but
    not yet run: ([("stash" | "wgrad" | "reduce", fn)], (d_w, d_b, d_dpt),
    stash). Running the fns in order fills the outputs; each raises on a
    launch error. raw_bwd_t runs them; chip_smoke.py times each."""
    from dfnet_tpu_torch.ops import build

    if not (spec.fine or spec.static):
        raise ValueError("raw_bwd_t takes a fine or a static pack")
    _check_width("raw_bwd_t", spec)
    N, S = z_all.shape
    dev = rays_o.device
    args = _fine_args(packed, spec, rays_o, rays_d, z_all, dpt)
    _check("g", g, (spec.n_raw, N, S), torch.float32, dev)
    _check_aligned16("raw_bwd_t", dpt, packed["b"])
    _check_tma("raw_bwd_t", packed["w"])
    d_w = torch.empty_like(packed["w"])
    d_b = torch.empty_like(packed["b"])
    d_dpt = torch.empty((N, spec.Wd), device=dev, dtype=torch.float32)
    Pp = bwd_points(N, S)
    R = bwd_stash_offsets(spec, Pp)
    stash = torch.empty(R["total"][0], device=dev, dtype=torch.bfloat16)
    regions = bwd_regions(spec)
    reg_off = (ctypes.c_longlong * len(regions))(*[R[n][0] for n, _ in regions])
    reg_width = (ctypes.c_int * len(regions))(*[w for _, w in regions])
    problems, jobs, n_jobs, chunk, n_chunks = _bwd_tables(spec, Pp, dev)
    nw, nb = d_w.numel(), d_b.numel()
    heads = _packed_offsets(_layout(spec)[0])["w_heads"]
    stride = -(-(nw + nb) // 64) * 64
    # bwd_reduce writes the heads' zero blocks without reading a partial
    partials = torch.empty((n_chunks, stride), device=dev, dtype=torch.float32)
    stream = _stream(d_w)

    def run_stash():
        _raise_on(build.load("raw_bwd", "dfn_raw_bwd_stash")(
            *args, int(spec.static), g.data_ptr(), stash.data_ptr(),
            ctypes.addressof(reg_off), ctypes.addressof(reg_width), len(regions),
            stream), "raw_bwd_t (bwd_stash)")

    def run_wgrad():
        _raise_on(build.load("raw_bwd", "dfn_raw_bwd_wgrad")(
            stash.data_ptr(), problems.data_ptr(), jobs.data_ptr(), n_jobs, Pp, chunk,
            n_chunks, nw, partials.data_ptr(), stride, stream), "raw_bwd_t (bwd_wgrad)")

    def run_reduce():
        _raise_on(build.load("raw_bwd", "dfn_raw_bwd_reduce")(
            partials.data_ptr(), n_chunks, stride, nw, nb, heads, spec.W, d_w.data_ptr(),
            d_b.data_ptr(), stash.data_ptr() + 2 * R["g_dt"][0], N, S, spec.Wd,
            d_dpt.data_ptr(), stream), "raw_bwd_t (bwd_reduce)")

    return ([("stash", run_stash), ("wgrad", run_wgrad), ("reduce", run_reduce)],
            (d_w, d_b, d_dpt), stash)


def raw_bwd_t(packed: Dict, rays_o, rays_d, z_all, dpt, g, spec: KernelSpec):
    """Backward of fine_raw_t (fine or static pack) for the float32
    cotangent g of its output: (d_w bf16 in packed["w"]'s layout, d_b
    float32 in packed["b"]'s layout, d_dpt (N, spec.Wd) float32). No
    cotangents for rays, z or freqs (stage-1 contract: z is sampled
    without gradient and rays carry no parameters).

    On the card, three launches (csrc/raw_bwd.cu): bwd_stash writes every
    weight's input activation and masked output cotangent to a bf16 stash
    in device memory (N*S rows; ~1.1 GB at the shipped fine train shape),
    bwd_wgrad sums the weight grads over chunks of points as a grouped
    GEMM, bwd_reduce adds the chunks in order and sums d_dpt per ray."""
    if not _on_cuda(rays_o):
        return raw_bwd_plain(packed, rays_o, rays_d, z_all, dpt, g, spec)
    N = z_all.shape[0]
    launches, out, _ = raw_bwd_launches(packed, rays_o, rays_d, z_all, dpt, g, spec)
    if N == 0:
        return out[0].zero_(), out[1].zero_(), out[2]
    for _, fn in launches:
        fn()
    LAUNCHES["raw_bwd_t"] += 1
    return out
