#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (dfnet_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   — compile every kernel of dfnet_tpu_torch/ops/csrc with nvcc
               (one process per source, in parallel) and print the time and
               ptxas' register / shared-memory report;
  2. kernels — call each kernel's wrapper on the inputs the render path
               gives it (trained assets, 16384 rays from the synthetic val
               cameras; the exact-union, culled and mono schedules) and on
               the inputs one full-width train step gives it (the static and
               the fine sweep forward and backward, 1536 rays of a train
               view), and hold it against its plain PyTorch version: raw
               outputs within atol/rtol 2e-2, composited rgb within 3e-2,
               fine z samples within 2e-3 absolute and sorted, except a 1e-5
               share (bf16 rounding flips, see FLIP_SHARE) that must stay
               within 10x those tolerances; gradients within 3e-2 x each
               packed entry's largest magnitude (TOL_GRAD; the per-ray d_dpt
               under the FLIP_SHARE rule); time kernel and plain version
               with CUDA events; for raw_bwd_t also each of its three
               launches (stash, wgrad, reduce), the stash's bytes and their
               write-once read-once floor, and the summed time of one
               torch.matmul per weight-grad problem over the same stash
               views (a yardstick the port never calls); for fine_raw_t
               the summed time of one torch.matmul per bf16 product of the
               sweep at the case's shapes (a yardstick the port never
               calls); for fine_composite_t fine_raw_t's time on the same
               inputs (the same sweep without the composite); and, in the
               log lines of fine_raw_t, fine_composite_t, coarse_sigma_t
               and proposal_z_rows, ptxas' registers and spills and the
               blocks an SM of the kernel the width runs. coarse_sigma_t
               also runs at the trainer's eval render of one val view;
  3. e2e     — save assets/nerfh_synthetic_301.npz as a checkpoint and run
               the port's stage-1 CLI with --render_test at the shipped
               full-width config; the coarse_sigma_t and fine_raw_t launch
               counts must rise and the val PSNR must be within 0.1 dB of
               the JAX package's figure (JAX_VAL_PSNR, computed on the CPU
               by tests/test_torch_port_render.py);
  4. render  — bench-style throughput: 2^20 rays from the val cameras in
               16384-ray chunks, under the exact-union schedule and the
               culled fused schedule (fine_composite_t must launch);
  5. mono    — the same 2^20 rays through the mono schedule
               (render_rays_fast(exact_union=False, mono=True):
               proposal_z_rows + fine_composite_t, and neither sweep kernel)
               and the two-kernel blended schedule: outputs agree at 3e-2
               under the FLIP_SHARE rule, the 4 val views' PSNR within
               PSNR_TOL_DB, rays/s of both; a mono call under lindisp must
               take the two-kernel path (the JAX schedule rule);
  6. frozen  — FrozenNeRF.from_experiment on the trained asset saved as a
               checkpoint (identity world setup): prerender_views of the val
               poses with tinyimg off and on (coarse_sigma_t and fine_raw_t
               must launch), kernel renders against the plain render_fn at
               3e-2, and the pose gradient of a photometric loss through
               render_fn on the card (finite, non-zero) against the port's
               CPU gradient at 3e-2 of its scale;
  7. probe   — the layer-stack probe (dfnet_tpu_torch/scripts/
               bench_int8_wide.py) at W=256 and W=128: both kernels against
               their plain versions (int8 exactly, also on weights that keep
               the stack non-zero; bf16 under bf16_stack_agreement, which
               must reject each faulty control), the marginal ms a layer
               and the int8/bf16 ratio; before it, the warpgroup MMA
               instructions (HGMMA, IGMMA) in the SASS of every mlp_stack
               kernel (each must hold some) and each kernel's registers and
               occupancy; after it, beside each stack at W=256, D=6, the
               time of D torch.matmul / torch._int_mm calls over its shapes
               (a yardstick the port never calls);
  8. train   — the port's stage-1 CLI trains the shipped full-width config
               from a seeded init on the synthetic scene for TRAIN_EPOCHS;
               the step must be the kernel step, every step must launch
               fine_raw_t and raw_bwd_t twice each, the loss must be finite
               and fall, and the final val PSNR must be within
               TRAIN_PSNR_TOL_DB of the JAX package's run (JAX_TRAIN_VAL_PSNR).
               Prints train steps/s and where a step's time goes;
  9. feature — stage 2: the port's stage-2 CLI at the shipped stage-2 config
               (configs/config_dfnet.txt: DFNet at full width, triplet, batch
               4, RVS, tinyimg, bf16) on a 240x320 synthetic scene of 200
               train and 100 val views, fed by FrozenNeRF on the trained
               asset, epochs 0-3. The pre-render and the RVS refresh must
               launch coarse_sigma_t and fine_raw_t (each also held against
               its plain version at a pre-render's shapes), every epoch's
               losses be finite, the best checkpoint reload with the same val
               MSE, and a median error print at epochs 0 and 3; DFNet float32
               on the card must match the CPU under the golden stage-2 step's
               bars (on that test's leaves) and bf16 track float32 under the
               bf16 bars (dfnet_tpu_torch/training/parity.py). Prints the pre-render's
               s, rays/s and launches, the RVS refresh s, the step's
               breakdown by CUDA events with its conv FLOPs' share of the
               bf16 peak, steps/s, validate s and the median errors.
  10. dm    — stage 3: the port's stage-3 CLI at the shipped stage-3 config
               (configs/config_dfnetdm.txt: DFNet at full width, svd_reg,
               combine_loss_w [0, 0, 1], level 0, val_on_psnr, lr 1e-5,
               bf16) fine-tuning phase 9's best checkpoint, fed by the
               trained asset's plain render (60x80 rays upsampled to
               240x320), on the 240x320 scene of DM_TRAIN train and DM_VAL
               val views, epochs 0-2. The run must launch none of the seven
               kernels (pose gradients need the plain renderer), every
               epoch's losses be finite, dL/dpose at the first step finite
               and non-zero, F's leaves move and G's and the NeRF's stay
               bit-identical, the best checkpoint reload with the same val
               pose MSE; bf16 track float32 (the predicted pose), the
               batched step at K=2 match the per-image step (5e-5, float32),
               and the float32 step on the card match the CPU at the CPU
               parity tests' inputs (dm_parity: at the CPU's render pose
               under the float32 bars, and at the card's own pose dL/dpose
               under parity.DM_DPOSE_OWN_POSE). `[dm]` lines give the
               step's breakdown by CUDA events, its idle share under
               torch.profiler, its operations and bounds,
               steps/s, eval_epoch s, the median errors, peak memory at
               K=1, 2 and 4 and the batched steps' images/s.
  11. sevenscenes — the three shipped configs (configs/config_nerfh.txt,
               config_dfnet.txt, config_dfnetdm.txt) through the port's three
               CLIs from an on-disk 7-Scenes replica (heads layout, two
               sequences of SEVEN_FRAMES 480x640 frames written by
               dfnet_tpu_torch/scripts/replica.py, PNGs read by
               data/png.py): stage 1 at df 4 (40 train / 4 val views), a
               --render_test at the seeded init and after epochs 0-5; stage 2
               at df 2 (40 train / 200 val) from stage 1's NeRF, once as
               shipped and once with --prefetch 2; stage 3 finetune_unlabel
               (40 views of the test sequence / 200 val) from stage 2's best
               checkpoint. Every scene a CLI loads must be the writer's
               (images and hists bit for bit, poses within 1e-6, gt_idx);
               stage 1 must launch coarse_sigma_t, fine_raw_t and raw_bwd_t,
               stage 2 coarse_sigma_t and fine_raw_t, stage 3 none; losses
               finite, stage 1's falling and its val PSNR 1 dB over the
               init's; the --prefetch run's losses within 1e-6. `[sevenscenes]`
               lines give the replica write s, the PNG decode ms a frame
               (filter 0 and Paeth), whether PIL imports, load s per split,
               stage-1 steps/s and val PSNR, stage-2 and stage-3 epoch s and
               the median errors;
  12. tools — on phase 11's replica and checkpoints, at the shipped
               configs: the checkpoint converters (the stage-1 checkpoint to
               a reference .tar, the stage-2 best to a .pt, and back through
               dfnet_tpu_torch.convert's main, bit for bit); FrozenNeRF from
               the .tar (its pre-render launches coarse_sigma_t on the coarse
               D=8 W=128 net and fine_raw_t and equals the proposal-less
               .npz's bit for bit; kernel against plain render_fn at 3e-2;
               ms a 16,384-ray chunk of the .tar and .npz paths); stage-2
               and stage-3 --eval from the .pt (the .npz's median errors) and
               the triplet axis a .pt start takes; the 120-frame spiral
               (--render_pose_only: launches, frames/s, the APNG's first
               frame against the first render); the split videos (rgb frames
               equal the split PNGs, disp over the split max);
               --render_feature_only's 2 x n_train PNGs; utils/metrics card
               against CPU; a device_trace naming both kernels;
               --check_numerics on a NaN leaf. `[tools]` lines.
Prints the card's name and power limit, one JSON line of per-kernel
numbers, and last {"ok": true, "device": {...}}.
"""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from dfnet_tpu_torch.ops.tolerances import (FLIP_CAP, FLIP_SHARE, TOL_COMP, TOL_GRAD,
                                            TOL_RAW, TOL_Z)

ROOT = Path(__file__).resolve().parent
# Mean val PSNR of the JAX package's --render_test on the trained W=128
# asset (plain XLA render, float32, CPU); see tests/test_torch_port_render.py.
JAX_VAL_PSNR = 33.04328536987305
PSNR_TOL_DB = 0.1
CHUNK = 1 << 14
N_RAYS = 1 << 20
CULLED = dict(cull_q=2e-3, n_fine=24, n_place=32, fuse_composite=True)
MONO = dict(exact_union=False, mono=True)
BLENDED = dict(exact_union=False, mono=False)
PROBE_POINTS = 1 << 21  # the layer-stack probe's default point count
# Val PSNR of the JAX package's stage-1 run with the flags of phase_train
# (seed 0, float32 plain train step on the CPU), from
#   JAX_PLATFORMS=cpu python run_nerf.py --dataset_type synthetic --NeRFH \
#     --encode_hist --basedir <dir> --expname nerfh --epochs 20 \
#     --i_weights 20 --i_testset 20
# (260 s on the CPU). Two repeats gave 12.827 and 12.579 dB: the epoch order
# is unseeded there, a 0.25 dB spread. The port draws other init and sample
# streams, hence the 1 dB tolerance.
JAX_TRAIN_VAL_PSNR = 12.598
TRAIN_PSNR_TOL_DB = 1.0
TRAIN_EPOCHS = 20
# phase_feature: configs/config_dfnet.txt's size (7-Scenes heads at df=2,
# 240x320; trainskip 5 keeps 200 train views); val cut from 1,000 to 100
FEATURE_TRAIN, FEATURE_VAL = 200, 100
FEATURE_H, FEATURE_W, FEATURE_FOCAL = 240, 320, 300.0   # the 48x64 field x5
FEATURE_EPOCHS = 3
FEATURE_STEP_REPS = 20
# phase_dm: configs/config_dfnetdm.txt (7-Scenes heads at df=2; 200 test
# frames at trainskip 5, 1,000 val) on phase_feature's scene, views cut
DM_TRAIN, DM_VAL = 40, 20
DM_EPOCHS = 2
DM_STEP_REPS = 10
DM_PARITY_VIEWS = (1, 3)
# phase_sevenscenes: a 7-Scenes replica in the heads layout at the
# dataset's 480x640 frames, two sequences of SEVEN_FRAMES (scripts/replica.py)
SEVEN_FRAMES = 200
SEVEN_STAGE1_EPOCHS = 5     # stage 1: epochs 0-5, a checkpoint at 5
SEVEN_EPOCHS = 1            # stages 2 and 3: epochs 0-1
SEVEN_PSNR_GAIN_DB = 1.0    # --render_test val PSNR over the seeded init's
SEVEN_PREFETCH_TOL = 1e-6   # stage-2 epoch losses with and without --prefetch 2
PEAK_BF16 = 989e12          # H100 SXM dense bf16 FLOP/s (data sheet)
PEAK_INT8 = 1979e12         # H100 SXM dense int8 OP/s (data sheet)
PEAK_F32 = 67e12            # H100 SXM float32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12       # H100 SXM HBM3 bytes/s (data sheet)
REPLACES = {
    "coarse_sigma_t": "dfnet_tpu/ops/nerf_kernels.py:530",
    "fine_raw_t": "dfnet_tpu/ops/nerf_kernels.py:566",
    "fine_composite_t": "dfnet_tpu/ops/nerf_kernels.py:1177",
    "raw_bwd_t": "dfnet_tpu/ops/nerf_kernels.py:758",
    "proposal_z_rows": "dfnet_tpu/ops/nerf_kernels.py:1093",
    "mlp_stack_bf16": "scripts/bench_int8_wide.py:32",
    "mlp_stack_int8": "scripts/bench_int8_wide.py:43",
}
SOURCES = {
    "coarse_sigma_t": "dfnet_tpu_torch/ops/csrc/coarse_sigma.cu",
    "fine_raw_t": "dfnet_tpu_torch/ops/csrc/fine_raw.cu",
    "fine_composite_t": "dfnet_tpu_torch/ops/csrc/fine_composite.cu",
    "raw_bwd_t": "dfnet_tpu_torch/ops/csrc/raw_bwd.cu",
    "proposal_z_rows": "dfnet_tpu_torch/ops/csrc/proposal_z.cu",
    "mlp_stack_bf16": "dfnet_tpu_torch/ops/csrc/mlp_stack.cu",
    "mlp_stack_int8": "dfnet_tpu_torch/ops/csrc/mlp_stack.cu",
}


def log(*a):
    print(*a, flush=True)


def load_model(asset: str, width: int, device):
    from dfnet_tpu_torch.config import parse_args
    from dfnet_tpu_torch.models.factory import create_nerfh
    from dfnet_tpu_torch.training.checkpoints import load_pytree, params_from_numpy

    cfg = parse_args(["--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
                      "--netwidth", str(width), "--netwidth_fine", str(width)])
    model, init = create_nerfh(cfg, device="cpu")
    tree, _ = load_pytree(str(ROOT / "assets" / asset))
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                        for k, v in t.items()}
    if shapes(tree) != shapes(init):
        raise SystemExit(f"{asset}: param shapes differ from the W={width} model")
    return cfg, model, params_from_numpy(tree, device)


def val_rays(n: int, device):
    """n rays cycled over the synthetic val cameras (the bench's scene)."""
    import torch

    from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
    from dfnet_tpu_torch.render.rays import get_rays

    scene = make_synthetic_scene(n_train=24, n_val=6, H=48, W=64, focal=60.0,
                                 seed=0, appearance_jitter=0.1)
    ro, rd = [], []
    for pose in scene.val.poses:
        o, d = get_rays(scene.H, scene.W, scene.focal,
                        torch.as_tensor(pose, device=device))
        ro.append(o.reshape(-1, 3))
        rd.append(d.reshape(-1, 3))
    ro, rd = torch.cat(ro), torch.cat(rd)
    reps = -(-n // ro.shape[0])
    return (ro.repeat(reps, 1)[:n].contiguous(), rd.repeat(reps, 1)[:n].contiguous(),
            scene)


def spy_on(names, run):
    """Run run() with the named wrappers of ops/nerf_kernels.py wrapped;
    return {name: [(args, kwargs), ...]} of every call (the main path's
    inputs), in call order."""
    from dfnet_tpu_torch.ops import nerf_kernels as nk

    orig = {n: getattr(nk, n) for n in names}
    calls = {n: [] for n in names}

    def spy(name):
        def f(*a, **k):
            calls[name].append((a, k))
            return orig[name](*a, **k)
        return f

    try:
        for n in names:
            setattr(nk, n, spy(n))
        run()
    finally:
        for n, f in orig.items():
            setattr(nk, n, f)
    return calls


def capture(fast, settings, ro, rd, hist, **kw):
    """Run render_rays_fast once; the arguments of each kernel wrapper."""
    from dfnet_tpu_torch.render.fast import render_rays_fast

    calls = spy_on(("coarse_sigma_t", "fine_raw_t", "fine_composite_t",
                    "proposal_z_rows"),
                   lambda: render_rays_fast(fast, ro, rd, hist, settings, **kw))
    return {n: c[-1] for n, c in calls.items() if c}


def capture_train_step(trainer):
    """Run one train step; the arguments of its fine_raw_t and raw_bwd_t
    calls, keyed by the sweep ("static" coarse, "fine")."""
    calls = spy_on(("fine_raw_t", "raw_bwd_t"),
                   lambda: trainer.train_step(0, trainer.cfg.lrate))
    out = {}
    for name, cs in calls.items():
        for a, k in cs:
            spec = a[-1]
            out[(name, "static" if spec.static else "fine")] = (a, k)
    return out


def spec_and_samples(name: str, args) -> tuple:
    """The KernelSpec and the samples a ray of a sweep kernel's call."""
    if name in ("coarse_sigma_t", "proposal_z_rows"):
        return args[3], args[4]
    return args[-1], args[3].shape[1]


def work(name: str, args) -> tuple:
    """([(operations, peak rate of their type)], bytes) the function must do
    and move on these inputs: matmul flops at the real (unpadded) widths on
    the tensor cores, each input read once and each output written once."""
    if name.startswith("mlp_stack"):
        x, ws = args
        P, W = x.shape
        nbytes = x.numel() * x.element_size() + ws.numel() * ws.element_size() + 32 * P
        peak = PEAK_INT8 if name == "mlp_stack_int8" else PEAK_BF16
        return [(2 * W * W * P * ws.shape[0], peak)], nbytes
    packed, ro = args[0], args[1]
    spec, S = spec_and_samples(name, args)
    N = ro.shape[0]
    W, half, in0 = spec.W, spec.W // 2, 6 * spec.F + 3
    per = in0 * W + (spec.D - 1) * W * W + (in0 * W if spec.skip > 0 else 0)
    wbytes = packed["w"].numel() * 2 + packed["b"].numel() * 4
    if name == "coarse_sigma_t":
        return [(2 * (per + W) * N * S, PEAK_BF16)], 24 * N + wbytes + 4 * N * S
    if name == "proposal_z_rows":
        # the sweep, and the inverse CDF as the reference's S_f x (S-1)
        # compares a ray on the CUDA cores
        S_f = args[5]
        return ([(2 * (per + W) * N * S, PEAK_BF16), (N * S_f * (S - 1), PEAK_F32)],
                24 * N + wbytes + 4 * N * S_f)
    if spec.static:
        per += half * W + 3 * half + W                 # dir half of w_dt, heads
    else:
        per += W * W + 3 * half * half + 8 * half + W  # w_dt, transient, heads
    inputs = 24 * N + 4 * N * S + 4 * N * spec.Wd + wbytes
    if name == "raw_bwd_t":
        # recompute + input grads + weight grads; no input grad into x0
        macs = 3 * per - in0 * W * (2 if spec.skip > 0 else 1)
        return ([(2 * macs * N * S, PEAK_BF16)],
                inputs + 4 * spec.n_raw * N * S + wbytes + 4 * N * spec.Wd)
    out = {"fine_raw_t": 4 * spec.n_raw * N * S, "fine_composite_t": 32 * N}[name]
    return [(2 * per * N * S, PEAK_BF16)], inputs + out


def bound(name: str, args) -> tuple:
    """(bound_ms, "operations" or "bytes"): the larger of the operations'
    time at their type's peak and the bytes' time at the HBM rate."""
    terms, nbytes = work(name, args)
    t_ops = max(n / peak for n, peak in terms)
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def compare_rows(got, want, tol, rtol=None):
    """Kernel rows against the plain version: FLIP_SHARE may fall outside
    atol `tol` / rtol (`tol` unless given), none by more than FLIP_CAP times."""
    import torch

    rtol = tol if rtol is None else rtol
    err = (got - want).abs()
    ratio = err / (tol + rtol * want.abs())   # > 1: outside atol/rtol
    bad = int((ratio > 1).sum())
    worst = int(ratio.argmax())
    info = dict(max_abs_err=float(err.max()), out_of_tol=bad,
                worst=dict(row=worst // (err.numel() // err.shape[0]),
                           ratio=float(ratio.max()),
                           kernel=float(got.reshape(-1)[worst]),
                           plain=float(want.reshape(-1)[worst])))
    ok = (bad <= FLIP_SHARE * err.numel() and info["worst"]["ratio"] <= FLIP_CAP
          and bool(torch.isfinite(got).all()))
    return ok, info


def compare_grads(got, want, spec, S):
    """raw_bwd_t's (d_w, d_b, d_dpt) against raw_bwd_plain's: each packed
    weight and bias entry within TOL_GRAD of its largest magnitude; d_dpt
    per element within TOL_GRAD of its largest magnitude, but for a share
    S x FLIP_SHARE within FLIP_CAP times that. A d_dpt element sums the S
    samples of one ray, so it takes the ReLU mask flips (an activation at a
    rounding midpoint, see FLIP_SHARE) of S points, and one flip moves it
    by a few percent; the weight grads sum ~10^5 points and average such
    flips out."""
    import torch

    from dfnet_tpu_torch.ops import nerf_kernels as nk

    def named(r):
        return nk.unpack({"w": r[0], "b": r[1]}, spec)

    g, w = named(got), named(want)
    rel, max_abs, ok = {}, 0.0, True
    for k in w:
        a, b = g[k].float(), w[k].float()
        scale = max(a.abs().max().item(), b.abs().max().item(), 1e-12)
        e = (a - b).abs().max().item()
        rel[k] = e / scale
        max_abs = max(max_abs, e)
        ok = ok and bool(torch.isfinite(a).all()) and e <= TOL_GRAD * scale
    worst = max(rel, key=rel.get)
    a, b = got[2], want[2]
    scale = max(a.abs().max().item(), b.abs().max().item(), 1e-12)
    ratio = (a - b).abs() / (TOL_GRAD * scale)
    flips = int((ratio > 1).sum())
    max_abs = max(max_abs, (a - b).abs().max().item())
    ok = (ok and bool(torch.isfinite(a).all()) and flips <= S * FLIP_SHARE * a.numel()
          and ratio.max().item() <= FLIP_CAP)
    return ok, dict(max_abs_err=max_abs, worst=dict(entry=worst, rel=rel[worst]),
                    d_dpt=dict(rel=ratio.max().item() * TOL_GRAD, out_of_tol=flips,
                               n=a.numel()))


def bwd_parts(a, k):
    """raw_bwd_t's three launches timed one by one with CUDA events; the
    stash's bytes, read from the tensor; and the yardstick: one
    torch.matmul per problem of bwd_problems over the same stash views,
    summed (bf16 operands, float32 sums), which the port never calls."""
    import torch

    from dfnet_tpu_torch.ops import nerf_kernels as nk
    from dfnet_tpu_torch.utils.timing import cuda_ms

    launches, _, stash = nk.raw_bwd_launches(*a, **k)
    out = {f"{n}_ms": cuda_ms(fn, reps=5) for n, fn in launches}
    N, S = a[3].shape
    pairs = [(G, A) for G, A, _ in nk.bwd_problem_views(stash, a[-1], N, S)]
    out["wgrad_matmul_ms"] = cuda_ms(lambda: [torch.matmul(G.t(), A) for G, A in pairs],
                                     reps=5)
    out["stash_bytes"] = stash.numel() * stash.element_size()
    return out


def fine_raw_yardstick(a) -> float:
    """Summed ms of one torch.matmul per bf16 product of fine_raw_t on this
    case: every trunk, dt, transient and head matrix (the case's own
    weights, bf16) against a bf16 activation of the case's point count
    (random: the time does not depend on the values). The port never calls
    it."""
    import torch

    from dfnet_tpu_torch.ops import nerf_kernels as nk
    from dfnet_tpu_torch.utils.timing import cuda_ms

    packed, spec = a[0], a[-1]
    P, W, half = a[3].numel(), spec.W, spec.W // 2
    v = {n: w.bfloat16() for n, w in nk.unpack(packed, spec).items() if n.startswith("w")}
    gen = torch.Generator(device=a[1].device).manual_seed(0)
    act = {K: torch.randn((P, K), device=a[1].device, generator=gen).bfloat16()
           for K in {spec.K0, W, half}}
    mats = [(spec.K0, v["w0"])]
    for i in range(1, spec.D):
        mats += ([(spec.K0, v[f"wx{i}"]), (W, v[f"wh{i}"])] if i == spec.skip
                 else [(W, v[f"w{i}"])])
    heads = v["w_heads"]
    mats += [(W, v["w_dt"]), (W, heads[3:4]), (half, heads[0:3, :half])]
    if spec.fine:
        mats += [(half, v[f"w_tr{i}"]) for i in range(3)] + [(half, heads[4:9, half:])]
    pairs = [(act[K], w.t()) for K, w in mats]
    ms = cuda_ms(lambda: [torch.matmul(x, w) for x, w in pairs], reps=5)
    del act, pairs
    torch.cuda.empty_cache()
    return ms


def ptxas_lines(source: str, kernel: str) -> list:
    """ptxas' register and spill lines of the kernels of csrc/<source>.cu
    whose mangled name matches the regex `kernel`, from the library's build
    log (empty when the library came from disk)."""
    from dfnet_tpu_torch.ops import build

    lines, cur = [], None
    for line in build.ptxas_report(source).splitlines():
        if "Compiling entry function" in line:
            cur = re.search(kernel, line)
        elif cur and ("registers" in line or "spill" in line):
            lines.append(line.split(":", 1)[-1].strip())
    return lines


SWEEP_SOURCES = {"coarse_sigma_t": "coarse_sigma", "fine_raw_t": "fine_raw",
                 "fine_composite_t": "fine_composite", "proposal_z_rows": "proposal_z"}


def kernel_build(name: str, spec, S: int) -> str:
    """For the log only, not measured: ptxas' register and spill lines of
    the kernel this width runs (<source>_kernel<NJ>: NJ output fragments a
    warp, 4 at W > 128, 2 at W > 64, and 2 at W <= 64 too but for the
    sigma-only sweeps' 1) from the library's build log, and the blocks an
    SM and shared bytes a block from the CUDA occupancy calculator (and the
    rays a block, for fine_composite_t and proposal_z_rows)."""
    from dfnet_tpu_torch.ops import nerf_kernels as nk

    source = SWEEP_SOURCES[name]
    sigma_only = source in ("coarse_sigma", "proposal_z")
    nj = 4 if spec.W > 128 else (2 if spec.W > 64 or not sigma_only else 1)
    lines = ptxas_lines(source, source + rf"_kernelILi{nj}E")
    occ = {"fine_raw_t": lambda: nk.fine_raw_occupancy(spec.W, spec.F),
           "fine_composite_t": lambda: nk.fine_composite_occupancy(spec.W, spec.F, S),
           "coarse_sigma_t": lambda: nk.coarse_sigma_occupancy(spec.W, spec.F),
           "proposal_z_rows": lambda: nk.proposal_z_occupancy(spec.W, spec.F, S)}[name]()
    rays = f" rays_per_block={occ[2]}" if len(occ) > 2 else ""
    return f"NJ={nj} ptxas {lines} blocks_per_sm={occ[0]} smem_bytes={occ[1]}{rays}"


def stack_build(dtype: str, W: int) -> str:
    """For the log only, not measured: ptxas' register and spill lines of
    the mlp_stack kernel of a type and width, the blocks an SM and shared
    bytes a block from the CUDA occupancy calculator, and the block's
    geometry (consumer warpgroups, rows a tile, weight-ring stages)."""
    from dfnet_tpu_torch.ops import mlp_stack as ms

    T = "13__nv_bfloat16" if dtype == "bf16" else "a"
    lines = ptxas_lines("mlp_stack", rf"mlp_stack_kernelI{T}Li{W}E")
    blocks, smem = ms.mlp_stack_occupancy(dtype, W)
    g = ms.mlp_stack_geometry(dtype, W)
    return (f"ptxas {lines} blocks_per_sm={blocks} smem_bytes={smem} "
            f"consumer_warpgroups={g['ncw']} rows_per_tile={g['rows']} stages={g['stages']}")


def stack_sass() -> dict:
    """Warpgroup MMA instructions (HGMMA bf16, IGMMA int8) in the SASS of
    each kernel of the built mlp_stack library (cuobjdump -sass), by
    kernel: {"<type> W=<width>": {instruction: count}}."""
    from dfnet_tpu_torch.ops import build

    lib = build.build_all(["mlp_stack"])["mlp_stack"]
    cuobjdump = str(Path(build.nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*mlp_stack_kernelI(13__nv_bfloat16|a)Li(\d+)E", line)
        if m:
            cur = f"{'bf16' if m[1] != 'a' else 'int8'} W={m[2]}"
            out[cur] = {}
        elif cur:
            for op in re.findall(r"\b[HI]GMMA\.\S+", line):
                out[cur][op] = out[cur].get(op, 0) + 1
    return out


def measure(name, a, k, asset, sched):
    """One kernel call on the card against its plain version: agreement,
    CUDA-event times, the bound. Raises SystemExit on disagreement."""
    import torch

    from dfnet_tpu_torch.ops import nerf_kernels as nk
    from dfnet_tpu_torch.utils.timing import cuda_ms

    kern = getattr(nk, name)
    plain = {"coarse_sigma_t": nk.coarse_sigma_plain, "fine_raw_t": nk.fine_raw_plain,
             "fine_composite_t": nk.fine_composite_plain,
             "raw_bwd_t": nk.raw_bwd_plain, "proposal_z_rows": nk.proposal_z_plain}[name]
    spec, S = spec_and_samples(name, a)
    with torch.no_grad():
        got = kern(*a, **k)
        torch.cuda.synchronize()
        want = plain(*a, **k)
        if name == "raw_bwd_t":
            ok, info = compare_grads(got, want, spec, S)
        elif name == "proposal_z_rows":
            ok, info = compare_rows(got, want, TOL_Z, rtol=0.0)
            info["unsorted_rows"] = int((got[:, 1:] < got[:, :-1]).any(-1).sum())
            ok = ok and info["unsorted_rows"] == 0
        else:
            ok, info = compare_rows(got, want, TOL_COMP if name == "fine_composite_t"
                                    else TOL_RAW)
        ms = cuda_ms(lambda: kern(*a, **k), reps=7)
        plain_ms = cuda_ms(lambda: plain(*a, **k), reps=3, warmup=1)
    bound_ms, bound_by = bound(name, a)
    mode = "static" if spec.static else ("fine" if spec.fine else "sigma")
    shape = f"N={a[1].shape[0]} S={S} D={spec.D} W={spec.W} F={spec.F} {mode}"
    if name == "proposal_z_rows":
        shape += f" S_f={a[5]}"
    case = dict(name=name, asset=asset, schedule=sched, shape=shape, **info, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    if name == "raw_bwd_t":
        with torch.no_grad():
            case["parts"] = bwd_parts(a, k)
        torch.cuda.empty_cache()
    if name == "fine_raw_t":
        with torch.no_grad():
            case["yardstick_matmul_ms"] = fine_raw_yardstick(a)
    if name == "fine_composite_t":
        # the same sweep without the composite, at the same inputs
        with torch.no_grad():
            case["fine_raw_ms"] = cuda_ms(lambda: nk.fine_raw_t(*a, **k), reps=7)
    log(f"[kernels] {name:16s} {asset:30s} {sched:10s} {shape}: "
        f"{json.dumps(info)} ms={ms:.3f} plain_ms={plain_ms:.3f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})"
        + (f" yardstick_matmul_ms={case['yardstick_matmul_ms']:.3f}"
           if name == "fine_raw_t" else "")
        + (f" fine_raw_ms={case['fine_raw_ms']:.3f} "
           f"(ratio {ms / case['fine_raw_ms']:.3f})" if name == "fine_composite_t" else "")
        + (f" build (not measured): {kernel_build(name, spec, S)}"
           if name in SWEEP_SOURCES else "")
        + (f" parts={json.dumps(case['parts'])} stash floor (written and read once "
           f"at the HBM rate) {2 * case['parts']['stash_bytes'] / HBM_BYTES_S * 1e3:.4f} ms"
           if "parts" in case else ""))
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version ({asset}, "
                         f"{sched}, {shape}): {info}")
    return case


def train_trainer(width: int, device, scene=None):
    """A NeRFTrainer for the shipped config at this width on the stage-1
    synthetic scene (made here unless given)."""
    from dfnet_tpu_torch.config import parse_args
    from dfnet_tpu_torch.data.loader import load_scene
    from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer

    cfg = parse_args(["--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
                      "--netwidth", str(width), "--netwidth_fine", str(width),
                      "--device", str(device)])
    return NeRFTrainer(cfg, scene or load_scene(cfg), device=device)


def phase_kernels(device):
    import torch

    from dfnet_tpu_torch.models.factory import render_settings
    from dfnet_tpu_torch.render.fast import FastNeRFH
    from dfnet_tpu_torch.training.checkpoints import load_pytree

    ro, rd, scene = val_rays(CHUNK, device)
    hist = torch.zeros((1, 10), dtype=torch.int32, device=device)
    train_scene = None
    cases = []
    for asset, width in (("nerfh_synthetic_301.npz", 128),
                         ("nerfh_synthetic_301_w256.npz", 256)):
        cfg, model, params = load_model(asset, width, device)
        settings = render_settings(cfg, scene.near, scene.far, test=True)
        runs = [("exact", dict(), True), ("culled", CULLED, True), ("mono", MONO, True)]
        if width == 128:
            runs.append(("coarse-net", dict(), False))
        for sched, kw, use_prop in runs:
            fast = FastNeRFH.pack(params, model, use_proposal=use_prop)
            for name, (a, k) in capture(fast, settings, ro, rd, hist, **kw).items():
                if sched == "coarse-net" and name != "coarse_sigma_t":
                    continue
                cases.append(measure(name, a, k, asset, sched))
            torch.cuda.empty_cache()
        # one train step (N_rand rays of a train view, perturb on) from the
        # trained weights: both sweeps forward and backward
        tr = train_trainer(width, device, train_scene)
        train_scene = tr.scene
        tr.load_params_tree(load_pytree(str(ROOT / "assets" / asset))[0])
        for (name, sweep), (a, k) in capture_train_step(tr).items():
            cases.append(measure(name, a, k, asset, f"train-{sweep}"))
        # the trainer's eval render of one val view: its placement sweep
        calls = spy_on(("coarse_sigma_t",),
                       lambda: tr.render_split(tr.scene.val, max_images=1))
        a, k = calls["coarse_sigma_t"][-1]
        cases.append(measure("coarse_sigma_t", a, k, asset, "train-eval"))
        del tr
        torch.cuda.empty_cache()
    return cases


def phase_e2e(device):
    from dfnet_tpu_torch.cli.nerf import train
    from dfnet_tpu_torch.ops import nerf_kernels as nk
    from dfnet_tpu_torch.training.checkpoints import load_pytree, save_pytree

    tree, _ = load_pytree(str(ROOT / "assets" / "nerfh_synthetic_301.npz"))
    with tempfile.TemporaryDirectory() as base:
        save_pytree(os.path.join(base, "nerfh", "000301.npz"), {"params": tree},
                    global_step=301)
        nk.reset_launches()
        t0 = time.perf_counter()
        psnr = train(["--dataset_type", "synthetic", "--NeRFH", "--encode_hist",
                      "--render_test", "--basedir", base, "--expname", "nerfh",
                      "--device", str(device)])
        import torch

        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(nk.LAUNCHES)
    log(f"[e2e] --render_test val PSNR {psnr:.4f} dB (JAX {JAX_VAL_PSNR:.4f}), "
        f"{dt:.2f} s, launches {launches}")
    for k in ("coarse_sigma_t", "fine_raw_t"):
        if launches[k] <= 0:
            raise SystemExit(f"the render path did not launch {k}")
    if not abs(psnr - JAX_VAL_PSNR) <= PSNR_TOL_DB:
        raise SystemExit(f"val PSNR {psnr} is not within {PSNR_TOL_DB} dB of "
                         f"the JAX package's {JAX_VAL_PSNR}")
    return launches


def phase_render(device):
    import torch

    from dfnet_tpu_torch.models.factory import render_settings
    from dfnet_tpu_torch.ops import nerf_kernels as nk
    from dfnet_tpu_torch.render.fast import FastNeRFH, render_rays_fast

    cfg, model, params = load_model("nerfh_synthetic_301.npz", 128, device)
    ro, rd, scene = val_rays(N_RAYS, device)
    settings = render_settings(cfg, scene.near, scene.far, test=True)
    fast = FastNeRFH.pack(params, model)
    hist = torch.zeros((1, cfg.hist_bin), dtype=torch.int32, device=device)
    result = {}
    for sched, kw in (("exact", {}), ("culled_fused", CULLED)):
        def run():
            total = torch.zeros((), device=device)
            for i in range(0, N_RAYS, CHUNK):
                r = render_rays_fast(fast, ro[i:i + CHUNK], rd[i:i + CHUNK],
                                     hist, settings, **kw)
                total += r["rgb"].sum()
            return float(total)

        run()                                   # warm (lazy loads, allocator)
        nk.reset_launches()
        t0 = time.perf_counter()
        checksum = run()
        dt = time.perf_counter() - t0
        launches = dict(nk.LAUNCHES)
        if not np.isfinite(checksum):
            raise SystemExit(f"{sched}: non-finite render")
        result[sched] = dict(rays_per_s=N_RAYS / dt, seconds=dt, launches=launches)
        log(f"[render] {sched}: {N_RAYS} rays in {dt:.3f} s = "
            f"{N_RAYS / dt:.1f} rays/s, launches {launches}")
    if result["culled_fused"]["launches"]["fine_composite_t"] <= 0:
        raise SystemExit("the culled fused schedule did not launch fine_composite_t")
    return result


def render_chunks(fast, settings, ro, rd, hist, **kw):
    """render_rays_fast over CHUNK-ray chunks; the rgb/acc/depth rows."""
    import torch

    from dfnet_tpu_torch.render.fast import render_rays_fast

    outs = [render_rays_fast(fast, ro[i:i + CHUNK], rd[i:i + CHUNK], hist, settings,
                             **kw) for i in range(0, ro.shape[0], CHUNK)]
    return torch.cat([torch.cat([o["rgb"].t(), o["acc"][None], o["depth"][None]])
                      for o in outs], 1)


def phase_mono(device):
    """The mono schedule against the two-kernel blended one on the trained
    W=128 asset: launches, agreement, val PSNR and rays/s."""
    import torch

    from dfnet_tpu_torch.data.loader import load_scene
    from dfnet_tpu_torch.models.factory import render_settings
    from dfnet_tpu_torch.ops import nerf_kernels as nk
    from dfnet_tpu_torch.render.fast import FastNeRFH
    from dfnet_tpu_torch.render.rays import get_rays

    cfg, model, params = load_model("nerfh_synthetic_301.npz", 128, device)
    ro, rd, scene = val_rays(N_RAYS, device)
    settings = render_settings(cfg, scene.near, scene.far, test=True)
    fast = FastNeRFH.pack(params, model)
    hist = torch.zeros((1, cfg.hist_bin), dtype=torch.int32, device=device)
    val = load_scene(cfg).val                  # the stage-1 CLI's 4 val views
    result, rows = {}, {}
    for sched, kw in (("blended", BLENDED), ("mono", MONO)):
        render_chunks(fast, settings, ro[:CHUNK], rd[:CHUNK], hist, **kw)   # warm
        torch.cuda.synchronize()
        nk.reset_launches()
        t0 = time.perf_counter()
        rows[sched] = render_chunks(fast, settings, ro, rd, hist, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(nk.LAUNCHES)
        psnr = []
        for pose, h, img in zip(val.poses, val.hists, val.images):
            o, d = get_rays(scene.H, scene.W, scene.focal,
                            torch.as_tensor(pose, device=device))
            rgb = render_chunks(fast, settings, o.reshape(-1, 3), d.reshape(-1, 3),
                                torch.as_tensor(h, device=device)[None], **kw)[:3].t()
            mse = torch.mean((rgb - torch.as_tensor(img, device=device).reshape(-1, 3)) ** 2)
            psnr.append(-10.0 * float(torch.log10(mse)))
        result[sched] = dict(rays_per_s=N_RAYS / dt, seconds=dt, launches=launches,
                             val_psnr=float(np.mean(psnr)))
        log(f"[mono] {sched}: {N_RAYS} rays in {dt:.3f} s = {N_RAYS / dt:.1f} rays/s, "
            f"val PSNR {np.mean(psnr):.4f} dB, launches {launches}")
    ok, info = compare_rows(rows["mono"], rows["blended"], TOL_COMP)
    log(f"[mono] mono against blended (rgb, acc, depth rows): {json.dumps(info)}")
    # the schedule rule: under lindisp the sampler cannot serve, and a mono
    # call takes the two-kernel path
    nk.reset_launches()
    render_chunks(fast, dataclasses.replace(settings, lindisp=True), ro[:CHUNK],
                  rd[:CHUNK], hist, **MONO)
    gated = dict(nk.LAUNCHES)
    log(f"[mono] mono=True under lindisp: launches {gated}")
    if gated["proposal_z_rows"] or gated["fine_composite_t"] or not gated["fine_raw_t"]:
        raise SystemExit(f"a mono call under lindisp did not take the two-kernel path: "
                         f"{gated}")
    ml = result["mono"]["launches"]
    if ml["proposal_z_rows"] <= 0 or ml["fine_composite_t"] <= 0:
        raise SystemExit(f"the mono schedule did not launch its kernels: {ml}")
    if ml["coarse_sigma_t"] or ml["fine_raw_t"]:
        raise SystemExit(f"the mono schedule launched a sweep kernel: {ml}")
    if not ok:
        raise SystemExit(f"mono and blended renders disagree: {info}")
    gap = result["mono"]["val_psnr"] - result["blended"]["val_psnr"]
    if not abs(gap) <= PSNR_TOL_DB:
        raise SystemExit(f"mono val PSNR is {gap:+.4f} dB from the blended schedule's")
    result["agreement"] = info
    return result


def phase_frozen(device):
    """The frozen-NeRF service on the trained asset: kernel pre-renders with
    tinyimg off and on, their agreement with the plain renderer, and the
    pose gradient on the card against the CPU."""
    import torch

    from dfnet_tpu_torch.config import parse_args
    from dfnet_tpu_torch.data.loader import load_scene
    from dfnet_tpu_torch.ops import nerf_kernels as nk
    from dfnet_tpu_torch.training.checkpoints import load_pytree, save_pytree
    from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF

    tree, _ = load_pytree(str(ROOT / "assets" / "nerfh_synthetic_301.npz"))
    out = {}
    with tempfile.TemporaryDirectory() as base:
        save_pytree(os.path.join(base, "nerfh", "000301.npz"), {"params": tree},
                    global_step=301)
        argv = ["--dataset_type", "synthetic", "--NeRFH", "--encode_hist",
                "--basedir", base, "--expname", "nerfh"]
        sc = load_scene(parse_args(argv))

        def frozen(*flags, dev=device):
            cfg = parse_args(argv + list(flags) + ["--device", str(dev)])
            return FrozenNeRF.from_experiment(cfg, sc.hwf, sc.near, sc.far,
                                              sc.world_setup)

        for tag, flags in (("full", ()), ("tinyimg", ("--tinyimg",))):
            nerf = frozen(*flags)
            if not nerf.uses_fast_render:
                raise SystemExit("FrozenNeRF did not take the kernel render path")
            nk.reset_launches()
            t0 = time.perf_counter()
            imgs = nerf.prerender_views(sc.val.poses, sc.val.hists)
            dt = time.perf_counter() - t0
            launches = dict(nk.LAUNCHES)
            psnr = float(np.mean([-10 * np.log10(np.mean((a - b) ** 2))
                                  for a, b in zip(imgs, sc.val.images)]))
            log(f"[frozen] prerender_views ({tag}): {len(imgs)} views of "
                f"{imgs.shape[1:]} in {dt:.3f} s, val PSNR {psnr:.4f} dB, "
                f"launches {launches}")
            if imgs.shape != sc.val.images.shape or not np.isfinite(imgs).all():
                raise SystemExit(f"prerender_views ({tag}) gave {imgs.shape}")
            if launches["coarse_sigma_t"] <= 0 or launches["fine_raw_t"] <= 0:
                raise SystemExit(f"prerender_views ({tag}) did not launch the sweeps")
            out[tag] = dict(seconds=dt, val_psnr=psnr, launches=launches)
        # kernels against the plain renderer, both placing samples with the
        # coarse net (the plain renderer has no proposal placement)
        nerf = frozen("--proposal_render", "false")
        with torch.no_grad():
            got = torch.stack([nerf.render_at_pose(p, h)
                               for p, h in zip(sc.val.poses, sc.val.hists)])
            want = torch.stack([nerf.render_fn(nerf.params, torch.as_tensor(
                p, device=device), torch.as_tensor(h, device=device))
                for p, h in zip(sc.val.poses, sc.val.hists)])
        ok, info = compare_rows(got, want, TOL_COMP)
        log(f"[frozen] kernel render_at_pose against plain render_fn: {json.dumps(info)}")
        if not ok:
            raise SystemExit(f"FrozenNeRF kernel renders disagree with render_fn: {info}")
        out["agreement"] = info
        # d(photometric loss)/d(pose) through render_fn, card and CPU
        grads = []
        for dev in (device, torch.device("cpu")):
            nerf = frozen("--tinyimg", dev=dev)
            pose = torch.tensor(sc.val.poses[0], device=dev, requires_grad=True)
            rgb = nerf.render_fn(nerf.params, pose,
                                 torch.as_tensor(sc.val.hists[0], device=dev))
            loss = torch.mean((rgb - torch.as_tensor(sc.val.images[1], device=dev)) ** 2)
            loss.backward()
            grads.append(pose.grad.cpu().numpy())
        g, c = grads
        scale = float(np.abs(c).max())
        rel = float(np.abs(g - c).max()) / max(scale, 1e-30)
        log(f"[frozen] pose grad: card {g.ravel().tolist()}, |card - cpu| / scale {rel:.3e}")
        if not (np.isfinite(g).all() and np.abs(g).max() > 0 and scale > 0
                and rel <= TOL_COMP):
            raise SystemExit(f"pose gradient on the card is not within {TOL_COMP} of "
                             f"the CPU's: {g} vs {c}")
        out["pose_grad_rel_err"] = rel
    return out


def stack_yardstick(dtype: str, x, ws) -> float:
    """ms of D torch.matmul (bf16, chained) or torch._int_mm (int8, each on
    x: its int32 output is not an int8 input) calls over the stack's
    shapes, CUDA events; a yardstick the port never calls."""
    import torch

    from dfnet_tpu_torch.utils.timing import cuda_ms

    if dtype == "bf16":
        def run():
            h = x
            for w in ws:
                h = torch.matmul(h, w.t())
    else:
        def run():
            for w in ws:
                torch._int_mm(x, w.t())
    ms = cuda_ms(run, reps=5)
    torch.cuda.empty_cache()
    return ms


def phase_probe(device):
    """The layer-stack probe at W=256 and W=128: kernels against plain
    (not counted), then the timed probe run (counted); the stacks' build
    (registers, occupancy, warpgroup MMA instructions in the SASS) and, at
    the widest shape, the D-matmul yardstick."""
    import torch

    from dfnet_tpu_torch.ops import mlp_stack as ms
    from dfnet_tpu_torch.ops import nerf_kernels as nk
    from dfnet_tpu_torch.scripts import bench_int8_wide as probe

    sass = stack_sass()
    for kern, ops in sass.items():
        log(f"[probe] SASS of mlp_stack {kern}: warpgroup MMA {ops}")
    for dtype in probe.DTYPES:
        for W in ms.WIDTHS:
            if not sass.get(f"{dtype} W={W}"):
                raise SystemExit(f"mlp_stack {dtype} W={W}: no warpgroup MMA in its SASS")
            log(f"[probe] build of mlp_stack {dtype} W={W} (not measured): "
                f"{stack_build(dtype, W)}")
    out = {}
    for W in (256, 128):
        checks = probe.check(W, PROBE_POINTS, device)
        nk.reset_launches()
        res = probe.run(W, PROBE_POINTS, device)
        launches = {k: nk.LAUNCHES[k] for k in ("mlp_stack_bf16", "mlp_stack_int8")}
        if min(launches.values()) <= 0:
            raise SystemExit(f"the probe did not launch both kernels: {launches}")
        out[W] = dict(run=res, checks=checks, launches=launches)
    # each kernel's case at the probe's widest shape (W=256, D=6)
    D = max(probe.DEPTHS)
    cases = []
    for dtype in probe.DTYPES:
        x, ws = ms.probe_inputs(dtype, 256, PROBE_POINTS, D, device)
        bound_ms, bound_by = bound(f"mlp_stack_{dtype}", (x, ws))
        yard = stack_yardstick(dtype, x, ws)
        del x, ws
        torch.cuda.empty_cache()
        cases.append(dict(
            name=f"mlp_stack_{dtype}", asset="probe data", schedule="probe",
            shape=f"P={PROBE_POINTS} W=256 D={D}",
            max_abs_err=max(c["max_abs_err"] for c in out[256]["checks"][dtype].values()),
            ms=out[256]["run"][dtype]["ms"][D],
            plain_ms=out[256]["checks"][dtype][D]["plain_ms"],
            bound_ms=bound_ms, bound_by=bound_by, yardstick_matmul_ms=yard))
        log(f"[probe] mlp_stack_{dtype} P={PROBE_POINTS} W=256 D={D}: ms={cases[-1]['ms']:.3f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) yardstick_matmul_ms={yard:.3f}")
    launches = {k: sum(o["launches"][k] for o in out.values())
                for k in ("mlp_stack_bf16", "mlp_stack_int8")}
    return dict(widths=out, cases=cases, launches=launches, sass=sass)


def phase_train(device):
    """Stage-1 training through the port's CLI at the shipped config."""
    import torch

    from dfnet_tpu_torch.cli.nerf import train
    from dfnet_tpu_torch.ops import nerf_kernels as nk
    from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer

    epochs, trainers = [], []
    orig = NeRFTrainer.train_epoch

    def timed_epoch(self, epoch):
        """Each epoch's host seconds and launches (train_epoch ends in a
        host fetch of the loss, which waits for the card)."""
        before = dict(nk.LAUNCHES)
        t0 = time.perf_counter()
        out = orig(self, epoch)
        epochs.append(dict(epoch=epoch, seconds=time.perf_counter() - t0,
                           steps=len(self.scene.train),
                           launches={k: nk.LAUNCHES[k] - before[k] for k in before}))
        if not trainers:
            trainers.append(self)
        return out

    NeRFTrainer.train_epoch = timed_epoch
    try:
        with tempfile.TemporaryDirectory() as base:
            nk.reset_launches()
            t0 = time.perf_counter()
            psnr = train(["--dataset_type", "synthetic", "--NeRFH", "--encode_hist",
                          "--basedir", base, "--expname", "nerfh",
                          "--epochs", str(TRAIN_EPOCHS),
                          "--i_weights", str(TRAIN_EPOCHS),
                          "--i_testset", str(TRAIN_EPOCHS), "--device", str(device)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(nk.LAUNCHES)
            exp = Path(base) / "nerfh"
            with open(exp / "metrics.jsonl") as fh:
                loss = [json.loads(line)["loss"] for line in fh]
            saved = (exp / f"{TRAIN_EPOCHS:06d}.npz").exists()
    finally:
        NeRFTrainer.train_epoch = orig
    tr = trainers[0]
    steps = sum(e["steps"] for e in epochs)
    steady = epochs[1:]                      # epoch 0 loads the kernels
    steps_per_s = sum(e["steps"] for e in steady) / sum(e["seconds"] for e in steady)
    log(f"[train] {len(epochs)} epochs, {steps} steps in {wall:.2f} s (evals and "
        f"checkpoint included); {steps_per_s:.2f} steps/s over epochs 1-"
        f"{epochs[-1]['epoch']}; loss {loss[0]:.5f} -> {loss[-1]:.5f}; val PSNR "
        f"{psnr:.4f} dB (JAX {JAX_TRAIN_VAL_PSNR}); launches {launches}")
    if not tr.uses_fused_train:
        raise SystemExit("the shipped config did not take the kernel train step")
    for e in epochs:
        for k in ("fine_raw_t", "raw_bwd_t"):
            if e["launches"][k] != 2 * e["steps"]:
                raise SystemExit(f"epoch {e['epoch']}: {k} launched "
                                 f"{e['launches'][k]} times in {e['steps']} steps")
    if not saved or not np.all(np.isfinite(loss)) or not (
            np.mean(loss[-3:]) < np.mean(loss[:3])):
        raise SystemExit(f"training did not save, or its loss is not finite and "
                         f"falling: {loss}")
    if not abs(psnr - JAX_TRAIN_VAL_PSNR) <= TRAIN_PSNR_TOL_DB:
        raise SystemExit(f"trained val PSNR {psnr} is not within {TRAIN_PSNR_TOL_DB} "
                         f"dB of the JAX package's {JAX_TRAIN_VAL_PSNR}")
    return dict(steps=steps, steps_per_s=steps_per_s, wall_s=wall, val_psnr=psnr,
                loss_first=loss[0], loss_last=loss[-1], launches=launches,
                breakdown=step_breakdown(tr))


def step_breakdown(tr, reps: int = 10):
    """Where one train step's time goes, on the trained-from-scratch state:
    the step (host clock around `reps` steps and a sync), each kernel call
    of a step (CUDA events at its captured inputs), the Adam update and the
    proposal loss forward + backward (CUDA events). The rest is torch glue:
    sampling, packing, compositing, the NeRF-W loss and autograd."""
    import torch

    from dfnet_tpu_torch.models.losses import proposal_bound_loss
    from dfnet_tpu_torch.models.nerfw import nerfw_apply_rays
    from dfnet_tpu_torch.ops import nerf_kernels as nk
    from dfnet_tpu_torch.render.fused_train import render_rays_train_fused
    from dfnet_tpu_torch.render.volume import composite_nerfw
    from dfnet_tpu_torch.utils.timing import cuda_ms

    lr = tr.cfg.lrate
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        tr.train_step(i % len(tr.scene.train), lr)
    torch.cuda.synchronize()
    out = {"step_ms": (time.perf_counter() - t0) * 1e3 / reps}
    for (name, sweep), (a, k) in capture_train_step(tr).items():
        out[f"{name}[{sweep}]_ms"] = cuda_ms(lambda: getattr(nk, name)(*a, **k), reps=5)
    out["adam_ms"] = cuda_ms(lambda: tr.adam_update(lr), reps=5)

    sc, m, p = tr.scene, tr.model, tr.params
    from dfnet_tpu_torch.render.rays import get_rays

    ro, rd = get_rays(sc.H, sc.W, sc.focal, tr._poses[0])
    ro, rd = ro.reshape(-1, 3)[:tr.cfg.N_rand], rd.reshape(-1, 3)[:tr.cfg.N_rand]
    hist = tr._hists[0][None].expand(ro.shape[0], -1)
    with torch.no_grad():
        r = render_rays_train_fused(p, m, ro, rd, hist, tr.settings, tr.gen)

    def proposal():
        z = r["z_vals"]
        pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
        sig = nerfw_apply_rays(p["proposal"], m.cfg_proposal, m.embed_proposal(pts),
                               sigma_only=True)
        w = composite_nerfw(sig, z, output_transient=False, sigma_only=True)["weights"]
        proposal_bound_loss(w, z, r["weights_fine"], r["z_all"]).backward()

    out["proposal_loss_ms"] = cuda_ms(proposal, reps=5)
    kern = sum(v for k, v in out.items() if k.startswith(("fine_raw_t", "raw_bwd_t")))
    out["glue_ms"] = out["step_ms"] - kern - out["adam_ms"] - out["proposal_loss_ms"]
    log(f"[train] step breakdown (ms): {json.dumps(out)}")
    return out


def vgg_conv_flops(h: int, w: int) -> list:
    """[(name, forward FLOPs on one h x w image, (h, w, channels) out)] of
    the 13 VGG16 convs, in order."""
    from dfnet_tpu_torch.models.vgg import VGG16_LAYOUT

    out, cin = [], 3
    for e in VGG16_LAYOUT:
        if e == "M":
            h, w = h // 2, w // 2
            continue
        out.append((e[0], 2 * h * w * cin * e[1] * 9, (h, w, e[1])))
        cin = e[1]
    return out


def adapt_conv_flops(h: int, w: int, taps) -> dict:
    """Forward FLOPs of each tap's adapt convs (1x1 to 64, 5x5 to 128) on
    one h x w image."""
    at = {n: shape for n, _, shape in vgg_conv_flops(h, w)}
    return {t: 2 * at[t][0] * at[t][1] * (at[t][2] * 64 + 64 * 128 * 25) for t in taps}


def dfnet_conv_flops(h: int, w: int, n_enc: int, n_feat: int,
                     taps=("conv1_2", "conv3_3", "conv5_3")) -> int:
    """Forward conv FLOPs of one DFNet call: the 13 VGG16 convs over n_enc
    images of h x w, the adapt convs (1x1 to 64, 5x5 to 128) over n_feat."""
    return (n_enc * sum(f for _, f, _ in vgg_conv_flops(h, w))
            + n_feat * sum(adapt_conv_flops(h, w, taps).values()))


def feature_parity(device):
    """DFNet on the card against the CPU at float32 (the golden step's
    config and inputs, 4+4+4 images at 32x48, its bars on its leaves;
    PyTorch's TF32 default on: the port must keep its float32 convs IEEE
    itself), the float32 eval forward (predict) the same way, then bf16
    against float32 on the card at the same images."""
    import torch

    from dfnet_tpu_torch.config import parse_args
    from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
    from dfnet_tpu_torch.training import parity
    from dfnet_tpu_torch.training.feature_trainer import FeatureTrainer

    sc = make_synthetic_scene(n_train=4, n_val=2, H=32, W=48, focal=45.0)
    batch = parity.golden_batch()
    with tempfile.TemporaryDirectory() as base:
        def trainer(dev):
            cfg = parse_args(parity.GOLDEN_FLAGS + ["--featurenet_batch_size", "4",
                                                    "--basedir", base, "--device", str(dev)],
                             stage="feature")
            return FeatureTrainer(cfg, sc, None, gen=torch.Generator().manual_seed(0))

        want = parity.loss_and_grads(trainer("cpu"), batch)
        card = trainer(device)
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        x = torch.cat([batch[0], batch[1], batch[3]])
        try:
            got = parity.loss_and_grads(card, batch)
            eval_pose = card.predict(x.to(device))
        finally:
            torch.backends.cudnn.allow_tf32 = prev
        ok, info = parity.golden_agreement(*got, *want, leaves=parity.GOLDEN_LEAVES)
        _, every = parity.golden_agreement(*got, *want)
        worst = every["worst"]
        log(f"[feature] float32 card against CPU: loss {got[0]:.6f} / {want[0]:.6f} "
            f"(|d| {info['loss_err']:.3e}, bar {parity.LOSS_TOL}); relative grad errors "
            f"of the golden leaves {json.dumps(info['grad_err'])}; of every leaf, the "
            f"largest against its bar: {worst} {every['grad_err'][worst]:.3e}")
        if not ok:
            raise SystemExit(f"DFNet float32 on the card disagrees with the CPU: {info}")
        ok, eval_err = parity.eval_agreement(eval_pose, trainer("cpu").predict(x))
        log(f"[feature] float32 eval forward (predict) card against CPU: "
            f"pose |d| {eval_err:.3e} (bar {parity.EVAL_POSE_TOL} of max(|pose|, 1))")
        if not ok:
            raise SystemExit(f"DFNet's float32 eval forward on the card disagrees with "
                             f"the CPU: {eval_err}")
        x = x.to(device)
        ok, bf = parity.bf16_agreement(card.params, card.state, x)
        log(f"[feature] bf16 against float32 on the card: {json.dumps(bf)}")
        if not ok:
            raise SystemExit(f"DFNet bf16 does not track float32 on the card: {bf}")
    return {"float32_loss_err": info["loss_err"], "float32_grad_err": info["grad_err"],
            "float32_every_leaf_worst": [worst, every["grad_err"][worst]],
            "float32_eval_pose_err": eval_err, "bf16": bf}


def feature_step_breakdown(tr, reps: int = FEATURE_STEP_REPS):
    """One stage-2 step on its last batch of the run, by CUDA events: the
    whole step (median of reps), and apart: the encoder forward (13 convs,
    3B images), the adapt branches + upsample + stacking (2B images), the
    losses on those features (the triplet case is read on the host), the
    backward, and Adam. The forward parts run without autograd."""
    import torch

    from dfnet_tpu_torch.models import dfnet as dm
    from dfnet_tpu_torch.models.vgg import imagenet_normalize, vgg16_features
    from dfnet_tpu_torch.ops.resize import resize_bilinear_nchw
    from dfnet_tpu_torch.training import feature_losses as fl
    from dfnet_tpu_torch.utils.timing import cuda_ms

    t, r, p12, rp, pp = tr.last_batch
    cfg, mcfg, dt, lr = tr.cfg, tr.model_cfg, tr.compute_dtype, tr.scheduler.lr
    nb, (H, W) = t.shape[0], t.shape[-2:]
    out = {"step_ms": cuda_ms(lambda: tr.train_step(t, r, p12, rp, pp, lr), reps=reps)}
    with torch.no_grad():
        enc = {k: dm._cast(v, dt) for k, v in tr.params["encoder"].items()}
        xn = imagenet_normalize(torch.cat([t, r, rp])).to(dt)
        out["encoder_fwd_ms"] = cuda_ms(
            lambda: vgg16_features(enc, xn, mcfg.hypercolumn_layers), reps=reps)
        _, taps = vgg16_features(enc, xn, mcfg.hypercolumn_layers)

        def adapt():
            ups = [resize_bilinear_nchw(dm._adapt_level(
                tr.params["adapt"][str(i)], tr.state["adapt"][str(i)], f[:2 * nb],
                not cfg.freezeBN)[0].to(dt), H, W) for i, f in enumerate(taps)]
            return torch.stack([u[:nb] for u in ups]), torch.stack([u[nb:] for u in ups])

        out["adapt_upsample_ms"] = cuda_ms(adapt, reps=reps)
        f_t, f_r = adapt()
        _, pred, _ = dm.dfnet_forward(tr.params, tr.state, torch.cat([t, r, rp]), mcfg,
                                      compute_dtype=dt)

        def losses():
            return (fl.pose_loss(pred[:2 * nb], torch.cat([p12, p12])),
                    fl.triplet_loss_hard_negative_mining_plus(
                        f_r, f_t, cfg.triplet_margin, tr.triplet_axis),
                    fl.pose_loss(pred[2 * nb:], pp))

        out["losses_ms"] = cuda_ms(losses, reps=reps)
    times = []
    for _ in range(reps):
        loss, _ = tr.loss_fn(tr.params, tr.state, t, r, p12, rp, pp)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        loss.backward()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    out["backward_ms"] = float(np.median(times))
    out["adam_ms"] = cuda_ms(lambda: tr.adam_update(lr), reps=reps)
    out["rest_ms"] = out["step_ms"] - sum(out[k] for k in (
        "encoder_fwd_ms", "adapt_upsample_ms", "losses_ms", "backward_ms", "adam_ms"))
    flops = 3 * dfnet_conv_flops(H, W, 3 * nb, 2 * nb, mcfg.hypercolumn_layers)
    out["conv_tflop_step"] = flops / 1e12
    out["bf16_peak_share"] = flops / PEAK_BF16 / (out["step_ms"] / 1e3)
    out["steps_per_s_events"] = 1e3 / out["step_ms"]
    return out


def phase_feature(device, handoff: str):
    """Stage 2 through the port's CLI at the shipped stage-2 config
    (configs/config_dfnet.txt: DFNet, triplet, batch 4, RVS, tinyimg, bf16)
    on a 240x320 synthetic scene of FEATURE_TRAIN train and FEATURE_VAL val
    views, fed by FrozenNeRF on the trained asset, epochs 0..FEATURE_EPOCHS.
    Checks: the pre-render and the RVS refresh launch coarse_sigma_t and
    fine_raw_t; each kernel against its plain version at a pre-render's
    shapes; every epoch's losses finite; the best checkpoint reloads into a
    fresh trainer with the same val MSE; a median error at epochs 0 and the
    end; DFNet float32 card against CPU and bf16 against float32
    (feature_parity). Figures: pre-render s, rays/s and launches, RVS s, the
    step's breakdown and steps/s, validate s, median errors. The best
    checkpoint is copied into `handoff` for phase_dm ("best_ckpt")."""
    import torch

    from dfnet_tpu_torch.cli import feature as cli
    from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
    from dfnet_tpu_torch.ops import nerf_kernels as nk
    from dfnet_tpu_torch.training.checkpoints import load_pytree, save_pytree
    from dfnet_tpu_torch.training.feature_trainer import FeatureTrainer

    t0 = time.perf_counter()
    scene = make_synthetic_scene(n_train=FEATURE_TRAIN, n_val=FEATURE_VAL, H=FEATURE_H,
                                 W=FEATURE_W, focal=FEATURE_FOCAL, seed=0, device=device)
    rec = {"scene_s": time.perf_counter() - t0, "epochs": [], "evals": [], "validate_s": []}
    trainers = []

    def timed(fn):
        torch.cuda.synchronize()
        before, t = dict(nk.LAUNCHES), time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(seconds=time.perf_counter() - t,
                         launches={k: nk.LAUNCHES[k] - before[k] for k in before})

    class Timed(FeatureTrainer):
        """The CLI's trainer, timing its parts and keeping its last batch."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            trainers.append(self)

        def prerender_train_views(self):
            out, rec["prerender"] = timed(lambda: FeatureTrainer.prerender_train_views(self))
            return out

        def rvs_refresh(self, rng):
            out, rec["rvs"] = timed(lambda: FeatureTrainer.rvs_refresh(self, rng))
            return out

        def train_step(self, *a):
            self.last_batch = a[:5]
            return FeatureTrainer.train_step(self, *a)

        def train_epoch(self, *a):
            out, r = timed(lambda: FeatureTrainer.train_epoch(self, *a))
            rec["epochs"].append(dict(r, loss=out))
            return out

        def validate(self):
            out, r = timed(lambda: FeatureTrainer.validate(self))
            rec["validate_s"].append(r["seconds"])
            return out

        def eval_median_error(self, split=None):
            out, r = timed(lambda: FeatureTrainer.eval_median_error(self, split))
            rec["evals"].append(dict(median=out[0].tolist(), seconds=r["seconds"]))
            return out

    tree, _ = load_pytree(str(ROOT / "assets" / "nerfh_synthetic_301.npz"))
    with tempfile.TemporaryDirectory() as base:
        save_pytree(os.path.join(base, "nerfh", "000301.npz"), {"params": tree},
                    global_step=301)
        argv = ["--config", str(ROOT / "configs" / "config_dfnet.txt"),
                "--dataset_type", "synthetic", "--basedir", base,
                "--epochs", str(FEATURE_EPOCHS), "--i_eval", str(FEATURE_EPOCHS),
                "--device", str(device)]
        orig = cli.load_scene, cli.FeatureTrainer
        cli.load_scene, cli.FeatureTrainer = (lambda cfg, stage="nerf": scene), Timed
        try:
            nk.reset_launches()
            t0 = time.perf_counter()
            cli.train(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(nk.LAUNCHES)
        finally:
            cli.load_scene, cli.FeatureTrainer = orig
        tr = trainers[0]
        with open(Path(base) / "dfnet" / "metrics.jsonl") as fh:
            metrics = [json.loads(line) for line in fh]
        es = tr.early_stopping
        fresh = FeatureTrainer(tr.cfg, scene, None, device=device)
        fresh.load(es.last_path)
        reloaded = fresh.validate()
        ckpt = os.path.basename(es.last_path)
        best_ckpt = shutil.copy(es.last_path, os.path.join(handoff, ckpt))
    cfg = tr.cfg
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    log(f"[feature] card: {smi.strip()}")
    log(f"[feature] config {cfg.featurenet_batch_size=} {cfg.tripletloss=} "
        f"{cfg.random_view_synthesis=} {cfg.rvs_refresh_rate=} {cfg.tinyimg=} "
        f"{cfg.feature_precision=} {cfg.learning_rate=}; scene {FEATURE_H}x{FEATURE_W}, "
        f"{FEATURE_TRAIN} train / {FEATURE_VAL} val views, built on the card in "
        f"{rec['scene_s']:.3f} s; the run {wall:.2f} s, launches {launches}")
    if not tr.nerf.uses_fast_render:
        raise SystemExit("stage 2's FrozenNeRF did not take the kernel render path")
    for part in ("prerender", "rvs"):
        if not all(rec[part]["launches"][k] > 0 for k in ("coarse_sigma_t", "fine_raw_t")):
            raise SystemExit(f"stage 2's {part} did not launch both sweeps: {rec[part]}")
    n_rays = FEATURE_TRAIN * tr.nerf.rh * tr.nerf.rw
    pre = rec["prerender"]
    pre["rays_per_s"] = n_rays / pre["seconds"]
    log(f"[feature] pre-render: {FEATURE_TRAIN} views of {tr.nerf.rh}x{tr.nerf.rw} rays "
        f"({n_rays} rays) in {pre['seconds']:.4f} s = {pre['rays_per_s']:.1f} rays/s, "
        f"launches {pre['launches']}; RVS refresh {rec['rvs']['seconds']:.4f} s, "
        f"launches {rec['rvs']['launches']}")
    losses = [(m["train_loss"], m["val_loss"]) for m in metrics]
    steps = -(-FEATURE_TRAIN // cfg.featurenet_batch_size)
    steady = rec["epochs"][1:]
    steps_per_s = steps * len(steady) / sum(e["seconds"] for e in steady)
    log(f"[feature] epochs (train loss, val MSE): {losses}; epoch s "
        f"{[round(e['seconds'], 4) for e in rec['epochs']]} ({steps} steps each); "
        f"{steps_per_s:.2f} steps/s over epochs 1-{FEATURE_EPOCHS}; validate s "
        f"{[round(v, 4) for v in rec['validate_s']]}; median errors [m, deg] "
        f"{[e['median'] for e in rec['evals']]}")
    if len(losses) != FEATURE_EPOCHS + 1 or not np.all(np.isfinite(losses)):
        raise SystemExit(f"stage 2's losses are not finite over every epoch: {losses}")
    if len(rec["evals"]) != 2 or not np.all(np.isfinite([e["median"] for e in rec["evals"]])):
        raise SystemExit(f"stage 2 did not print a median error at epoch 0 and the end: "
                         f"{rec['evals']}")
    log(f"[feature] {ckpt} reloaded into a fresh trainer: val MSE {reloaded!r} "
        f"(logged {es.val_loss_min!r})")
    if not abs(reloaded - es.val_loss_min) <= 1e-5 * max(1.0, abs(es.val_loss_min)):
        raise SystemExit(f"the reloaded checkpoint gives val MSE {reloaded}, not "
                         f"{es.val_loss_min}")
    step = feature_step_breakdown(tr)
    log(f"[feature] step breakdown (ms, CUDA events; B={cfg.featurenet_batch_size}, "
        f"{3 * cfg.featurenet_batch_size} encoder images): {json.dumps(step)}")
    calls = spy_on(("coarse_sigma_t", "fine_raw_t"), lambda: tr.nerf.render_at_pose(
        scene.train.poses[0], scene.train.hists[0]))
    cases = [measure(n, *calls[n][-1], "nerfh_synthetic_301.npz", "feature")
             for n in ("coarse_sigma_t", "fine_raw_t")]
    del tr, fresh, trainers[:]
    torch.cuda.empty_cache()
    return dict(launches=launches, wall_s=wall, prerender=pre, rvs=rec["rvs"],
                epochs=[dict(e, loss=l) for e, l in zip(rec["epochs"], losses)],
                steps_per_s=steps_per_s, validate_s=rec["validate_s"], evals=rec["evals"],
                reloaded_val=reloaded, step=step, parity=feature_parity(device),
                cases=cases, best_ckpt=best_ckpt)


def nerf_point_flops(p: dict, width: int, sigma_only: bool) -> int:
    """Matmul FLOPs a sample point of one NeRF-W net's forward: every
    layer's (rows, cols), but only the W point rows of `dir` and
    `trans_0` (their direction and embedding rows are per ray)."""
    keys = [k for k in p if isinstance(p[k], dict) and "w" in p[k]
            and (not sigma_only or k.startswith("xyz_") and k != "xyz_final"
                 or k == "static_sigma")]
    rows = lambda k: width if k in ("dir", "trans_0") else p[k]["w"].shape[0]
    return 2 * sum(rows(k) * p[k]["w"].shape[1] for k in keys)


def dm_step_ops(tr) -> dict:
    """The operations of one stage-3 step (K=1) on its inputs. The render:
    float32 MLP FLOPs of the coarse sweep forward (its output feeds only
    the detached fine z) and the fine sweep forward and input-gradient
    backward (the NeRF's weights are frozen), per-ray work left out. DFNet
    (bf16 convs): F on one image, forward, weight and input gradients (no
    input gradient of conv1_1); G on [image; render], forward with the
    adapt branch on all levels, and the input-gradient backward of both
    images through the encoder up to the deepest selected tap and the
    selected adapt levels (the batch's input needs a gradient, so autograd
    computes it for both)."""
    nerf, s = tr.nerf, tr.nerf.settings
    rays = nerf.rh * nerf.rw
    W = nerf.model.cfg_fine.W
    coarse = nerf_point_flops(nerf.params["coarse"], nerf.model.cfg_coarse.W, True)
    fine = nerf_point_flops(nerf.params["fine"], W, False)
    render = rays * (s.N_samples * coarse + 2 * (s.N_samples + s.N_importance) * fine)
    H, Wd = tr.scene.H, tr.scene.W
    enc = vgg_conv_flops(H, Wd)
    taps = tr.model_cfg.hypercolumn_layers
    adapt = adapt_conv_flops(H, Wd, taps)
    sel = [taps[i] for i in tr.cfg.feature_matching_lvl]
    deepest = max(i for i, (n, _, _) in enumerate(enc) if n in sel)
    f_enc = sum(f for _, f, _ in enc)
    dfnet = (2 * f_enc + sum(f for _, f, _ in enc[1:])
             + 2 * (f_enc + sum(adapt.values()))
             + 2 * (sum(f for _, f, _ in enc[:deepest + 1]) + sum(adapt[t] for t in sel)))
    return {"render_f32_tflop": render / 1e12, "render_bound_ms": render / PEAK_F32 * 1e3,
            "fine_mflop_a_point": fine / 1e6, "coarse_mflop_a_point": coarse / 1e6,
            "dfnet_bf16_tflop": dfnet / 1e12, "dfnet_bound_ms": dfnet / PEAK_BF16 * 1e3}


def dm_step_breakdown(tr, i: int = 0, reps: int = DM_STEP_REPS) -> dict:
    """One stage-3 step (K=1, train view i) by CUDA events: the whole step
    (median of reps), and apart, each with autograd recording as in the
    step: F forward (with the SVD projection), the render forward, G
    forward + losses, the backward, Adam."""
    import torch

    from dfnet_tpu_torch.models.dfnet import conv_precision
    from dfnet_tpu_torch.utils.timing import cuda_ms

    images, poses12, hists = tr.train_data
    img, p12, h = images[i:i + 1], poses12[i:i + 1], hists[i:i + 1]
    nerf, dt = tr.nerf, tr.compute_dtype
    out = {"step_ms": cuda_ms(lambda: tr.train_step(img, p12, h), reps=reps)}
    with conv_precision(dt):
        out["f_forward_ms"] = cuda_ms(lambda: tr.predict_poses(tr.params, img, dt), reps=reps)
        poses = tr.predict_poses(tr.params, img, dt)
        out["render_forward_ms"] = cuda_ms(lambda: tr.render(nerf.params, poses, h), reps=reps)
        rgbs = tr.render(nerf.params, poses, h)
        out["g_forward_loss_ms"] = cuda_ms(
            lambda: tr.match_losses(poses, rgbs, tr.feat_params, img, p12), reps=reps)
        del poses, rgbs
        times = []
        for _ in range(reps):
            loss = tr.batched_loss_fn(tr.params, nerf.params, tr.feat_params, img, p12, h)[0]
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            loss.backward()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
            tr.optimizer.zero_grad(set_to_none=True)
    out["backward_ms"] = float(np.median(times))
    out["adam_ms"] = cuda_ms(tr.adam_update, reps=reps)
    out["rest_ms"] = out["step_ms"] - sum(out[k] for k in (
        "f_forward_ms", "render_forward_ms", "g_forward_loss_ms", "backward_ms", "adam_ms"))
    out["render_share"] = out["render_forward_ms"] / out["step_ms"]
    out["steps_per_s_events"] = 1e3 / out["step_ms"]
    return out


def dm_step_profile(tr, i: int = 0, steps: int = 5) -> dict:
    """The stage-3 step (K=1, train view i) of the phase's own trainer under
    torch.profiler: the device's busy time a step (the kernels' summed
    device time) against the step's host time, the idle share, the float32
    GEMMs' device time (the render's MLP) and the five kernels with the
    most device time. The idle share is None when the profiler records no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    images, poses12, hists = tr.train_data
    step = lambda: tr.train_step(images[i:i + 1], poses12[i:i + 1], hists[i:i + 1])
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    ev = prof.key_averages()
    ms = lambda e: e.self_device_time_total / 1e3 / steps
    busy = sum(ms(e) for e in ev)
    sgemm = sum(ms(e) for e in ev if "gemm" in e.key and ("sgemm" in e.key or "f32" in e.key))
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:5]
    return {"step_host_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall if busy > 0 else None, "float32_gemm_ms": sgemm,
            "top_kernels_ms": [(e.key[:80], e.count // steps, ms(e)) for e in top]}


def dm_peak_memory(tr, k: int) -> float:
    """Peak device bytes (GB) of one update on k train views."""
    import torch

    images, poses12, hists = tr.train_data
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr.train_step(images[:k], poses12[:k], hists[:k])
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def dm_parity(device):
    """The DM step on the card against the CPU at float32, at the CPU
    parity tests' config and inputs (training/parity.py::dm_trainer: the
    48x64 scene, the D=2 W=32 NeRF, DFNet at full width), on train views
    DM_PARITY_VIEWS, with PyTorch's TF32 default on for cuDNN: F's
    predicted pose within EVAL_POSE_TOL; then, the card rendering at the
    CPU's predicted pose (the DM gradient is not smooth in the pose below
    float32's rounding of it, parity.dm_loss_and_grads), the loss within
    LOSS_TOL, dL/dpose (fc_pose/b's gradient) within GRAD_TOL of its scale
    and F's gradients on DM_LEAVES under the float32 bars, F's adapt leaves
    below ZERO_GRAD on both sides; and the card rendering at its own
    predicted pose, dL/dpose within DM_DPOSE_OWN_POSE of its scale; for
    combine_loss_w [0.2, 0.3, 0.5] and [0, 0, 1]."""
    import torch

    from dfnet_tpu_torch.training import parity

    out = {}
    with tempfile.TemporaryDirectory() as base:
        for w in ("0.2,0.3,0.5", "0,0,1"):
            cpu = parity.dm_trainer(base, "cpu", "--combine_loss_w", w)
            card = parity.dm_trainer(base, device, "--combine_loss_w", w)
            sc = cpu.scene
            for i in DM_PARITY_VIEWS:
                view = (sc.train.images[i], sc.train.poses[i].reshape(1, 12),
                        sc.train.hists[i])
                want = parity.dm_loss_and_grads(cpu, *view)
                prev = torch.backends.cudnn.allow_tf32
                torch.backends.cudnn.allow_tf32 = True
                try:
                    got = parity.dm_loss_and_grads(card, *view, render_pose=want[3])
                    own = parity.dm_loss_and_grads(card, *view)
                finally:
                    torch.backends.cudnn.allow_tf32 = prev
                pose_ok, pose_err = parity.eval_agreement(torch.tensor(got[3]),
                                                          torch.tensor(want[3]))
                ok, info = parity.dm_agreement(got[0], got[2], want[0], want[2],
                                               leaves=parity.DM_LEAVES)
                dp_ref = want[2]["fc_pose/b"]
                scale = float(np.abs(dp_ref).max())
                rel = lambda g: float(np.abs(g["fc_pose/b"] - dp_ref).max()) / scale
                ok = (ok and pose_ok and scale > 0 and rel(got[2]) < parity.GRAD_TOL
                      and rel(own[2]) < parity.DM_DPOSE_OWN_POSE
                      and np.isfinite(got[2]["fc_pose/b"]).all())
                key = f"[{w}] view {i}"
                out[key] = {"loss": [got[0], want[0]], "loss_err": info["loss_err"],
                            "pose_err": pose_err, "dpose_err": rel(got[2]),
                            "dpose_err_own_pose": rel(own[2]),
                            "dpose_own_pose_bar": parity.DM_DPOSE_OWN_POSE,
                            "dpose_scale": scale,
                            "grad_err": {k: info["grad_err"][k] for k in parity.DM_LEAVES},
                            "adapt_max": info["adapt_max"]}
                log(f"[dm] float32 card against CPU, combine_loss_w {key}: "
                    f"{json.dumps(out[key])}")
                if not ok:
                    raise SystemExit(f"the DM step on the card disagrees with the CPU: "
                                     f"{out[key]}")
    return out


def phase_dm(device, stage2_ckpt: str):
    """Stage 3 through the port's CLI at configs/config_dfnetdm.txt (DFNet
    at full width, svd_reg, combine_loss_w [0, 0, 1], level 0,
    val_on_psnr, lr 1e-5, bf16), fine-tuning phase_feature's best stage-2
    checkpoint, the frozen NeRF the trained asset (60x80 renders
    upsampled to 240x320), on the 240x320 synthetic scene of DM_TRAIN
    train and DM_VAL val views, epochs 0..DM_EPOCHS. Checks: no kernel
    launches in the run; every epoch's losses finite; dL/dpose at the first
    step finite and non-zero; F's leaves move, G's and the NeRF's stay
    bit-identical; the best checkpoint reloads into a fresh trainer with the
    same val pose loss; bf16 against float32 on the card (the predicted
    pose); the batched step at K=2 against the per-image step at float32;
    float32 card against CPU (dm_parity). Figures: the step's breakdown,
    its device busy time and idle share (dm_step_profile), its operations
    and bounds, steps/s, eval_epoch s, median errors, peak
    memory at K=1, 2 and 4, the K=2 and K=4 steps' time."""
    import torch

    from dfnet_tpu_torch.cli import dm as cli
    from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
    from dfnet_tpu_torch.models.dfnet import conv_precision
    from dfnet_tpu_torch.ops import nerf_kernels as nk
    from dfnet_tpu_torch.training import parity
    from dfnet_tpu_torch.training.checkpoints import load_pytree, save_pytree
    from dfnet_tpu_torch.training.dm_trainer import DMTrainer
    from dfnet_tpu_torch.training.nerf_trainer import named_leaves
    from dfnet_tpu_torch.utils.timing import cuda_ms

    scene = make_synthetic_scene(n_train=DM_TRAIN, n_val=DM_VAL, H=FEATURE_H, W=FEATURE_W,
                                 focal=FEATURE_FOCAL, seed=0, device=device)
    rec = {"epochs": [], "evals": [], "eval_epoch_s": []}
    trainers = []

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    snap = lambda tree: [v.detach().clone() for _, v in named_leaves(tree)]

    class Timed(DMTrainer):
        """The CLI's trainer, timing its parts, keeping its leaves at the
        start and dL/dpose of its first step."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            trainers.append(self)
            self.start = (snap(self.params), snap(self.feat_params), snap(self.nerf.params))
            self.first_dpose = None

        def train_step(self, *a):
            out = DMTrainer.train_step(self, *a)
            if self.first_dpose is None:
                self.first_dpose = dict(self._named)["fc_pose/b"].grad.cpu().numpy()
            return out

        def train_epoch(self, rng):
            out, s = timed(lambda: DMTrainer.train_epoch(self, rng))
            rec["epochs"].append(dict(seconds=s, loss=out[0], psnr=out[1]))
            return out

        def eval_epoch(self):
            out, s = timed(lambda: DMTrainer.eval_epoch(self))
            rec["eval_epoch_s"].append(s)
            return out

        def eval_median_error(self, split=None):
            out, s = timed(lambda: DMTrainer.eval_median_error(self, split))
            rec["evals"].append(dict(median=out[0].tolist(), seconds=s))
            return out

    tree, _ = load_pytree(str(ROOT / "assets" / "nerfh_synthetic_301.npz"))
    with tempfile.TemporaryDirectory() as base:
        save_pytree(os.path.join(base, "nerfh", "000301.npz"), {"params": tree},
                    global_step=301)
        argv = ["--config", str(ROOT / "configs" / "config_dfnetdm.txt"),
                "--dataset_type", "synthetic", "--basedir", base,
                "--pretrain_model_path", stage2_ckpt,
                "--pretrain_featurenet_path", stage2_ckpt,
                "--epochs", str(DM_EPOCHS), "--i_eval", str(DM_EPOCHS),
                "--device", str(device)]
        orig = cli.load_scene, cli.DMTrainer
        cli.load_scene, cli.DMTrainer = (lambda cfg, stage="nerf": scene), Timed
        try:
            nk.reset_launches()
            t0 = time.perf_counter()
            cli.train(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(nk.LAUNCHES)
        finally:
            cli.load_scene, cli.DMTrainer = orig
        tr = trainers[0]
        with open(Path(base) / "dfnetdm" / "metrics.jsonl") as fh:
            metrics = [json.loads(line) for line in fh]
        es = tr.early_stopping
        best = os.path.basename(es.last_path)
        best_epoch = int(best.split("-")[1])
        fresh = DMTrainer(tr.cfg.replace(pretrain_model_path=es.last_path), scene, tr.nerf,
                          device=device)
        reloaded = fresh.eval_epoch()[0]
        del fresh
    cfg = tr.cfg
    log(f"[dm] config {cfg.combine_loss_w=} {cfg.feature_matching_lvl=} {cfg.svd_reg=} "
        f"{cfg.val_on_psnr=} {cfg.learning_rate=} {cfg.feature_precision=} "
        f"{cfg.freezeBN=} {cfg.N_rand=} {cfg.dm_batch_size=}; NeRF D={cfg.netdepth_fine} "
        f"W={cfg.netwidth_fine} {cfg.N_samples}+{cfg.N_importance} samples at "
        f"{tr.nerf.rh}x{tr.nerf.rw} -> {FEATURE_H}x{FEATURE_W}; {DM_TRAIN} train / "
        f"{DM_VAL} val views; from {os.path.basename(stage2_ckpt)}; the run {wall:.2f} s, "
        f"launches {launches}")
    if any(launches.values()):
        raise SystemExit(f"stage 3 launched kernels, and its renders must take the plain "
                         f"renderer: {launches}")
    losses = [(m["train_loss"], m["val_loss"], m["train_psnr"], m["val_psnr"])
              for m in metrics]
    steady = rec["epochs"][1:]
    steps_per_s = DM_TRAIN * len(steady) / sum(e["seconds"] for e in steady)
    log(f"[dm] epochs (train loss, val pose MSE, train PSNR, val PSNR): {losses}; epoch s "
        f"{[round(e['seconds'], 4) for e in rec['epochs']]} ({DM_TRAIN} steps each); "
        f"{steps_per_s:.3f} steps/s over epochs 1-{DM_EPOCHS}; eval_epoch s "
        f"{[round(v, 4) for v in rec['eval_epoch_s']]}; median errors [m, deg] "
        f"{[e['median'] for e in rec['evals']]}")
    if len(losses) != DM_EPOCHS + 1 or not np.all(np.isfinite(losses)):
        raise SystemExit(f"stage 3's losses are not finite over every epoch: {losses}")
    if len(rec["evals"]) != 2 or not np.all(np.isfinite([e["median"] for e in rec["evals"]])):
        raise SystemExit(f"stage 3 did not print a median error at epoch 0 and the end: "
                         f"{rec['evals']}")
    dpose = tr.first_dpose
    log(f"[dm] dL/dpose at the first step (fc_pose/b's gradient): {dpose.tolist()}")
    if not (np.isfinite(dpose).all() and np.abs(dpose).max() > 0):
        raise SystemExit(f"dL/dpose at the first step is not finite and non-zero: {dpose}")
    f0, g0, n0 = tr.start
    moved = sum(not torch.equal(a, b) for a, (_, b) in zip(f0, named_leaves(tr.params)))
    same_g = all(torch.equal(a, b) for a, (_, b) in zip(g0, named_leaves(tr.feat_params)))
    same_n = all(torch.equal(a, b) for a, (_, b) in zip(n0, named_leaves(tr.nerf.params)))
    log(f"[dm] F: {moved} of {len(f0)} leaves moved; G bit-identical {same_g}; NeRF "
        f"bit-identical {same_n}")
    if not (moved and same_g and same_n):
        raise SystemExit("stage 3 must move F's leaves and leave G's and the NeRF's as "
                         "they were")
    logged = metrics[best_epoch]["val_loss"]
    log(f"[dm] {best} reloaded into a fresh trainer: val pose MSE {reloaded!r} (logged "
        f"{logged!r})")
    if not abs(reloaded - logged) <= 1e-5 * max(1.0, abs(logged)):
        raise SystemExit(f"the reloaded checkpoint gives val pose MSE {reloaded}, not "
                         f"{logged}")

    step = dm_step_breakdown(tr)
    profiled = dm_step_profile(tr)
    ops = dm_step_ops(tr)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    log(f"[dm] card: {smi.strip()}")
    log(f"[dm] step breakdown (ms, CUDA events; K=1): {json.dumps(step)}")
    log(f"[dm] step under torch.profiler (ms a step, K=1): {json.dumps(profiled)}")
    log(f"[dm] step operations and bounds: {json.dumps(ops)}")
    memory = {f"K={k}": dm_peak_memory(tr, k) for k in (1, 2, 4)}
    log(f"[dm] peak memory (GB, max_memory_allocated over one update): {json.dumps(memory)}")
    images, poses12, hists = tr.train_data
    batched = {f"K={k}": cuda_ms(lambda k=k: tr.train_step(images[:k], poses12[:k], hists[:k]),
                                 reps=DM_STEP_REPS) for k in (2, 4)}
    batched = {k: {"step_ms": v, "images_per_s": int(k[2:]) * 1e3 / v}
               for k, v in batched.items()}
    log(f"[dm] batched steps (CUDA events; K=1 {1e3 / step['step_ms']:.2f} images/s): "
        f"{json.dumps(batched)}")

    # bf16 (the run's precision) against float32 on the card, and the batched
    # step against the per-image step at float32, at full width
    f32 = DMTrainer(cfg.replace(feature_precision="fp32"), scene, tr.nerf, device=device)
    view = (scene.train.images[0], scene.train.poses[0].reshape(1, 12), scene.train.hists[0])
    bf = DMTrainer(cfg, scene, tr.nerf, device=device)
    with torch.no_grad():
        pose_bf = bf.predict_poses(bf.params, images[:1], torch.bfloat16)
        pose_32 = f32.predict_poses(f32.params, images[:1])
    loss_bf, _, g_bf, _ = parity.dm_loss_and_grads(bf, *view)
    loss_32, _, g_32, _ = parity.dm_loss_and_grads(f32, *view)
    a, b = g_32["fc_pose/b"].astype(np.float64), g_bf["fc_pose/b"].astype(np.float64)
    pose_err = float((pose_bf - pose_32).abs().max())
    pose_bar = parity.BF16_POSE * max(float(pose_32.abs().max()), 1.0)
    bf16 = {"pose_err": pose_err, "pose_bar": pose_bar, "loss": [loss_bf, loss_32],
            "loss_diff": loss_bf - loss_32,
            "dpose_cos": float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))}
    log(f"[dm] bf16 against float32 on the card (train view 0): {json.dumps(bf16)}")
    if not (pose_err < pose_bar and np.isfinite([loss_bf, loss_32]).all()):
        raise SystemExit(f"stage 3's bf16 pose does not track float32: {bf16}")
    with torch.no_grad(), conv_precision(torch.float32):
        args = (f32.params, tr.nerf.params, f32.feat_params)
        _, (lk, _) = f32.batched_loss_fn(*args, images[:2], poses12[:2], hists[:2])
        l1 = [float(f32.loss_fn(*args, images[i], poses12[i:i + 1], hists[i])[0])
              for i in range(2)]
    k2 = {"batched": lk.tolist(), "per_image": l1,
          "err": float(np.abs(lk.cpu().numpy() - np.array(l1)).max())}
    log(f"[dm] batched step (K=2, float32) against the per-image step: {json.dumps(k2)}")
    if not k2["err"] < 5e-5:
        raise SystemExit(f"the batched step's losses miss the per-image step's: {k2}")
    del tr, f32, bf, trainers[:]
    torch.cuda.empty_cache()
    return dict(launches=launches, wall_s=wall, epochs=rec["epochs"], losses=losses,
                steps_per_s=steps_per_s, eval_epoch_s=rec["eval_epoch_s"], evals=rec["evals"],
                first_dpose=dpose.tolist(), reloaded_val=reloaded, step=step,
                profile=profiled, ops=ops, peak_memory_gb=memory, batched_steps=batched,
                bf16=bf16, batched_parity=k2, parity=dm_parity(device))


def seven_expected(rec: dict, seq: int, skip: int, df: float) -> dict:
    """What the loader must return for a replica sequence at (skip, df):
    the writer's uint8 frames / 255 area-downscaled, their histograms, the
    sphere poses and the frame indices."""
    from dfnet_tpu_torch.data.color import downscale_area, luminance_histogram

    images = np.stack([downscale_area((f / 255.0).astype(np.float32), df)
                       for f in rec["frames"][seq][::skip]])
    return {"images": images, "poses": rec["poses"][seq][::skip],
            "hists": np.stack([luminance_histogram(im) for im in images]),
            "gt_idx": np.arange(0, len(rec["frames"][seq]), skip)}


def check_seven_scene(name: str, scene, want_train: dict, want_val: dict) -> dict:
    """Hold a scene a CLI loaded to the writer's: images and hists equal,
    poses within 1e-6 of the sphere poses, gt_idx equal. Raises otherwise."""
    out = {}
    for part, split, want in (("train", scene.train, want_train), ("val", scene.val, want_val)):
        pose_err = float(np.abs(split.poses - want["poses"]).max())
        ok = (split.images.shape == want["images"].shape
              and np.array_equal(split.images, want["images"])
              and np.array_equal(split.hists, want["hists"])
              and np.array_equal(split.gt_idx, want["gt_idx"]) and pose_err <= 1e-6)
        out[part] = {"views": len(split), "hw": list(split.images.shape[1:3]),
                     "pose_err": pose_err}
        if not ok:
            raise SystemExit(f"[sevenscenes] {name}: the {part} split the CLI loaded is not "
                             f"the replica's: {out[part]}, gt_idx {split.gt_idx[:6]}...")
    return out


def phase_sevenscenes(device):
    """The three shipped configs (configs/config_nerfh.txt, config_dfnet.txt,
    config_dfnetdm.txt) through the port's CLIs from an on-disk 7-Scenes
    replica (scripts/replica.py: the heads layout, two sequences of
    SEVEN_FRAMES 480x640 frames of the blob field rendered on the card at
    focal 585; seq-02 train, seq-01 test), overriding only --datadir,
    --basedir, the epochs (and stage 1's --i_weights, so that its last
    epoch leaves a checkpoint) and the stage links. Stage 1: --render_test
    at the seeded init, epochs 0-SEVEN_STAGE1_EPOCHS, --render_test. Stage 2:
    epochs 0-SEVEN_EPOCHS from stage 1's NeRF, once as shipped and once with
    --prefetch 2 (cuDNN deterministic for both). Stage 3 (finetune_unlabel):
    epochs 0-SEVEN_EPOCHS from stage 2's best checkpoint. Checks: every scene
    a CLI loads is the writer's (check_seven_scene); stage 1 launches
    coarse_sigma_t, fine_raw_t and raw_bwd_t, stage 2 coarse_sigma_t and
    fine_raw_t, stage 3 none; every epoch's losses finite, stage 1's train
    loss falls, its val PSNR at least SEVEN_PSNR_GAIN_DB over the init's;
    stage 2's epoch losses with and without --prefetch within
    SEVEN_PREFETCH_TOL. Figures: replica write s, PNG decode ms a frame
    (filter 0 and Paeth), whether PIL imports, load s per split, stage-1
    steps/s and val PSNR, stage-2 and stage-3 epoch s, median pose errors.
    The replica and the checkpoints stay for phase_tools (`handoff`); the
    caller removes them."""
    import torch

    from dfnet_tpu_torch.cli import dm as dm_cli
    from dfnet_tpu_torch.cli import feature as feature_cli
    from dfnet_tpu_torch.cli import nerf as nerf_cli
    from dfnet_tpu_torch.data import loader, png
    from dfnet_tpu_torch.ops import nerf_kernels as nk
    from dfnet_tpu_torch.scripts.replica import write_seven_scenes_replica
    from dfnet_tpu_torch.training.dm_trainer import DMTrainer
    from dfnet_tpu_torch.training.feature_trainer import FeatureTrainer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    root = ROOT / "build" / "sevenscenes"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    rec = write_seven_scenes_replica(str(root / "data"), n_frames=SEVEN_FRAMES, device=device)
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    frame = root / "data" / "deepslam_data" / "7Scenes" / "heads" / "seq-01"
    frame = str(frame / "frame-000000.color.png")
    paeth = str(root / "paeth.png")
    with open(paeth, "wb") as fh:
        fh.write(png.encode_png(rec["frames"][1][0], 4))
    decode = {}
    for name, path, reps in (("filter0", frame, 20), ("paeth", paeth, 3)):
        if not np.array_equal(png.read_png(path), rec["frames"][1][0]):
            raise SystemExit(f"[sevenscenes] {path} does not decode to the frame written")
        t = time.perf_counter()
        for _ in range(reps):
            png.read_png(path)
        decode[name] = {"ms": (time.perf_counter() - t) / reps * 1e3,
                        "bytes": os.path.getsize(path)}
    pil = subprocess.run([sys.executable, "-c", "import PIL"], capture_output=True).returncode == 0
    log(f"[sevenscenes] card: {smi.strip()}")
    log(f"[sevenscenes] replica: {2 * SEVEN_FRAMES} frames of 480x640 written in {write_s:.3f} "
        f"s; PNG decode (data/png.py) ms a frame {json.dumps(decode)}; PIL imports: {pil}")

    loads, scenes, epochs = [], {}, {"feature": [], "dm": []}
    orig_split = loader.load_seven_scenes_split

    def timed_split(*a, **k):
        t = time.perf_counter()
        out = orig_split(*a, **k)
        loads.append({"train": k["train"], "skip": k["skip"], "df": k["df"],
                      "views": len(out), "s": time.perf_counter() - t})
        return out

    def recording(cli, key):
        orig = cli.load_scene

        def load(cfg, stage="nerf"):
            scenes.setdefault(key, []).append(orig(cfg, stage=stage))
            return scenes[key][-1]
        return orig, load

    def timing(cls, key):
        orig = cls.train_epoch

        def run(self, *a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig(self, *a)
            torch.cuda.synchronize()
            epochs[key].append(time.perf_counter() - t)
            return out
        return orig, run

    def leg(fn):
        nk.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(nk.LAUNCHES)

    cfgdir = ROOT / "configs"
    base, base_b = root / "logs", root / "logs_prefetch"
    link = ["--datadir", rec["datadir"], "--device", str(device)]
    patches = [(loader, "load_seven_scenes_split", timed_split),
               (nerf_cli, "load_scene", recording(nerf_cli, "nerf")[1]),
               (feature_cli, "load_scene", recording(feature_cli, "feature")[1]),
               (dm_cli, "load_scene", recording(dm_cli, "dm")[1]),
               (FeatureTrainer, "train_epoch", timing(FeatureTrainer, "feature")[1]),
               (DMTrainer, "train_epoch", timing(DMTrainer, "dm")[1])]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    deterministic = torch.backends.cudnn.deterministic
    try:
        for obj, name, f in patches:
            setattr(obj, name, f)
        stage1 = ["--config", str(cfgdir / "config_nerfh.txt"), "--basedir", str(base)] + link
        (psnr_init, l_init) = leg(lambda: nerf_cli.train(stage1 + ["--render_test"]))
        (_, l_train) = leg(lambda: nerf_cli.train(
            stage1 + ["--epochs", str(SEVEN_STAGE1_EPOCHS),
                      "--i_weights", str(SEVEN_STAGE1_EPOCHS)]))
        (psnr, l_render) = leg(lambda: nerf_cli.train(stage1 + ["--render_test"]))
        shutil.copytree(base / "nerfh", base_b / "nerfh")
        torch.backends.cudnn.deterministic = True
        stage2 = ["--config", str(cfgdir / "config_dfnet.txt"), "--epochs",
                  str(SEVEN_EPOCHS)] + link
        (err2, l_feature) = leg(lambda: feature_cli.train(stage2 + ["--basedir", str(base)]))
        (err2b, l_feature_b) = leg(lambda: feature_cli.train(
            stage2 + ["--basedir", str(base_b), "--prefetch", "2"]))
        torch.backends.cudnn.deterministic = deterministic
        ckpt = sorted((base / "dfnet").glob("checkpoint-*.npz"))[-1]
        (err3, l_dm) = leg(lambda: dm_cli.main(
            ["--config", str(cfgdir / "config_dfnetdm.txt"), "--basedir", str(base),
             "--epochs", str(SEVEN_EPOCHS), "--pretrain_model_path", str(ckpt),
             "--pretrain_featurenet_path", str(ckpt)] + link))
    finally:
        torch.backends.cudnn.deterministic = deterministic
        for obj, name, f in saved:
            setattr(obj, name, f)

    def metrics(path):
        with open(path) as fh:
            return [json.loads(line) for line in fh]

    m1 = metrics(base / "nerfh" / "metrics.jsonl")
    m2, m2b = metrics(base / "dfnet" / "metrics.jsonl"), metrics(base_b / "dfnet" / "metrics.jsonl")
    m3 = metrics(base / "dfnetdm" / "metrics.jsonl")

    # the scenes each CLI loaded against the writer's
    e1 = (seven_expected(rec, 2, 5, 4.0), seven_expected(rec, 1, 50, 4.0))
    e2 = (seven_expected(rec, 2, 5, 2.0), seven_expected(rec, 1, 1, 2.0))
    e3 = (seven_expected(rec, 1, 5, 2.0), e2[1])
    held = {}
    for key, want in (("nerf", e1), ("feature", e2), ("dm", e3)):
        for i, sc in enumerate(scenes[key]):
            held[f"{key}[{i}]"] = check_seven_scene(f"{key} load {i}", sc, *want)
    if len(scenes["nerf"]) != 3 or len(scenes["feature"]) != 2 or len(scenes["dm"]) != 1:
        raise SystemExit(f"[sevenscenes] the CLIs loaded {[(k, len(v)) for k, v in scenes.items()]}"
                         " scenes, not 3, 2 and 1")
    log(f"[sevenscenes] scenes the CLIs loaded equal the writer's (images and hists bit for "
        f"bit, poses within 1e-6 of the sphere poses, gt_idx): {json.dumps(held)}; "
        f"stage 3 (finetune_unlabel) train gt_idx = seq-01's frames 0, 5, ..., "
        f"{scenes['dm'][0].train.gt_idx[-1]}")
    log(f"[sevenscenes] load s per split: {json.dumps(loads)}")

    # stage 1
    leg1 = {k: l_init[k] + l_train[k] + l_render[k] for k in l_train}
    steps = len(scenes["nerf"][1].train)
    losses1 = [m["loss"] for m in m1]
    steps_per_s = steps * SEVEN_STAGE1_EPOCHS / sum(m["epoch_s"] for m in m1[1:])
    sc1, sc2 = scenes["nerf"][1], scenes["feature"][0]
    log(f"[sevenscenes] stage 1 (config_nerfh.txt, df 4 -> {sc1.H}x{sc1.W}, {steps} train / "
        f"{len(sc1.val)} val views): epochs 0-{SEVEN_STAGE1_EPOCHS} losses "
        f"{losses1}, {steps_per_s:.3f} steps/s over epochs 1-{SEVEN_STAGE1_EPOCHS} "
        f"({steps} steps each); --render_test val PSNR {psnr!r} dB against {psnr_init!r} at "
        f"the seeded init; launches: init render {l_init}, train {l_train}, render {l_render}")
    if not all(leg1[k] > 0 for k in ("coarse_sigma_t", "fine_raw_t", "raw_bwd_t")):
        raise SystemExit(f"[sevenscenes] stage 1 did not launch its three kernels: {leg1}")
    if not (np.all(np.isfinite(losses1)) and losses1[-1] < losses1[0]):
        raise SystemExit(f"[sevenscenes] stage 1's train loss is not finite and falling: {losses1}")
    if not psnr >= psnr_init + SEVEN_PSNR_GAIN_DB:
        raise SystemExit(f"[sevenscenes] stage 1's val PSNR {psnr} is not {SEVEN_PSNR_GAIN_DB} "
                         f"dB over the init's {psnr_init}")

    # stage 2
    losses2 = [(m["train_loss"], m["val_loss"]) for m in m2]
    losses2b = [(m["train_loss"], m["val_loss"]) for m in m2b]
    gap = float(np.abs(np.array(losses2) - np.array(losses2b)).max())
    log(f"[sevenscenes] stage 2 (config_dfnet.txt, df 2 -> {sc2.H}x{sc2.W}, "
        f"{len(sc2.train)} train / {len(sc2.val)} val): "
        f"epochs (train loss, val MSE) {losses2}; with --prefetch 2 {losses2b} (largest gap "
        f"{gap!r}); epoch s {[round(t, 4) for t in epochs['feature']]} (runs without, then "
        f"with --prefetch); median error [m, deg] {np.asarray(err2[0]).tolist()} / "
        f"{np.asarray(err2b[0]).tolist()}; launches {l_feature} / {l_feature_b}")
    if not all(l_feature[k] > 0 for k in ("coarse_sigma_t", "fine_raw_t")):
        raise SystemExit(f"[sevenscenes] stage 2 did not launch both sweeps: {l_feature}")
    if len(losses2) != SEVEN_EPOCHS + 1 or not np.all(np.isfinite(losses2 + losses2b)):
        raise SystemExit(f"[sevenscenes] stage 2's losses are not finite: {losses2}, {losses2b}")
    if not gap <= SEVEN_PREFETCH_TOL:
        raise SystemExit(f"[sevenscenes] --prefetch 2 changed stage 2's losses by {gap}")

    # stage 3
    losses3 = [(m["train_loss"], m["val_loss"], m["train_psnr"], m["val_psnr"]) for m in m3]
    log(f"[sevenscenes] stage 3 (config_dfnetdm.txt, finetune_unlabel: "
        f"{len(scenes['dm'][0].train)} train views of seq-01 / {len(scenes['dm'][0].val)} val, "
        f"from {ckpt.name}): epochs (train loss, val pose MSE, train PSNR, val PSNR) "
        f"{losses3}; epoch s {[round(t, 4) for t in epochs['dm']]}; median error [m, deg] "
        f"{np.asarray(err3[0]).tolist()}; launches {l_dm}")
    if any(l_dm.values()):
        raise SystemExit(f"[sevenscenes] stage 3 launched kernels: {l_dm}")
    if len(losses3) != SEVEN_EPOCHS + 1 or not np.all(np.isfinite(losses3)):
        raise SystemExit(f"[sevenscenes] stage 3's losses are not finite: {losses3}")
    launches = {k: leg1[k] + l_feature[k] + l_feature_b[k] + l_dm[k] for k in leg1}
    handoff = dict(root=str(root), datadir=rec["datadir"], base=str(base),
                   stage1=str(base / "nerfh" / f"{SEVEN_STAGE1_EPOCHS:06d}.npz"),
                   stage2=str(ckpt))
    return dict(handoff=handoff, launches=launches, write_s=write_s, decode=decode, pil=pil, loads=loads,
                stage1=dict(losses=losses1, steps_per_s=steps_per_s, val_psnr=psnr,
                            val_psnr_init=psnr_init, launches=leg1),
                stage2=dict(losses=losses2, losses_prefetch=losses2b, prefetch_gap=gap,
                            epoch_s=epochs["feature"], median=np.asarray(err2[0]).tolist(),
                            launches=l_feature),
                stage3=dict(losses=losses3, epoch_s=epochs["dm"],
                            median=np.asarray(err3[0]).tolist(), launches=l_dm))


def _leaves(tree, prefix=""):
    """{path: numpy array} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.detach().cpu().numpy() if hasattr(v, "detach") \
                else np.asarray(v)
    return out


def _same_leaves(got: dict, want: dict) -> bool:
    """Same paths, dtypes and shapes, and every leaf equal bit for bit."""
    got, want = _leaves(got), _leaves(want)
    return sorted(got) == sorted(want) and all(
        got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want)


def phase_tools(device, handoff: dict):
    """The converters, the spiral and video renders and the eval utilities
    at the shipped configs, on phase_sevenscenes' replica and checkpoints
    (`handoff`): export the stage-1 checkpoint to a reference `.tar` and
    the stage-2 best to a `.pt`, and convert both back, through
    `python -m dfnet_tpu_torch.convert`'s main (leaves bit-equal, times);
    FrozenNeRF from the `.tar` (as --ft_path), whose pre-render must launch
    coarse_sigma_t on the coarse D=8 W=128 net and fine_raw_t and equal the
    pre-render of the `.npz` less its proposal net bit for bit, and whose
    kernel renders agree with the plain render_fn at TOL_COMP (and the
    `.tar` and `.npz` paths' ms a 16,384 rays by CUDA events); --eval of
    stages 2 and 3 from the `.pt` (the median errors of the `.npz`) and the
    triplet axis of a stage-2 start from it; cli.nerf --render_pose_only
    (120 frames at 120x160: launches, the APNG's frame count, its first
    frame against to8b of the first rendered one, frames/s); --render_test
    --render_video_train --render_video_test (each rgb frame the split's
    PNG, each disp frame over the split's max disp); --render_feature_only
    (2 x n_train PNGs); utils/metrics ssim and psnr of the val renders, card
    against CPU within 1e-5; a device_trace of one render that names both
    kernels; --check_numerics raising FloatingPointError on a NaN in the
    fine net's rgb bias (and what a NaN in a hidden weight does)."""
    import torch

    from dfnet_tpu_torch import convert
    from dfnet_tpu_torch.cli import dm as dm_cli
    from dfnet_tpu_torch.cli import feature as feature_cli
    from dfnet_tpu_torch.cli import nerf as nerf_cli
    from dfnet_tpu_torch.config import parse_args
    from dfnet_tpu_torch.data import png
    from dfnet_tpu_torch.data.loader import load_scene
    from dfnet_tpu_torch.models.losses import to8b
    from dfnet_tpu_torch.ops import nerf_kernels as nk
    from dfnet_tpu_torch.training.checkpoints import load_pytree, save_pytree
    from dfnet_tpu_torch.training.feature_losses import triplet_axis
    from dfnet_tpu_torch.training.feature_trainer import FeatureTrainer
    from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF
    from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer
    from dfnet_tpu_torch.utils import metrics, profiling
    from dfnet_tpu_torch.utils.timing import cuda_ms

    root = Path(handoff["root"]) / "tools"
    root.mkdir(parents=True, exist_ok=True)
    base, data = handoff["base"], ["--datadir", handoff["datadir"], "--device", str(device)]
    cfgdir = ROOT / "configs"
    nerf_argv = ["--config", str(cfgdir / "config_nerfh.txt"), "--basedir", base] + data
    feat_argv = ["--config", str(cfgdir / "config_dfnet.txt"), "--basedir", base] + data
    dm_argv = ["--config", str(cfgdir / "config_dfnetdm.txt"), "--basedir", base] + data
    out, launches = {}, {}

    def leg(name, fn):
        torch.cuda.synchronize()
        nk.reset_launches()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[f"{name}_s"] = time.perf_counter() - t
        launches[name] = dict(nk.LAUNCHES)
        return res

    # --- the converters, both ways through main
    tar, pt = str(root / "nerf.tar"), str(root / "dfnet.pt")
    back_nerf, back_dfnet = str(root / "nerf_back.npz"), str(root / "dfnet_back.npz")
    conv = {}
    for name, argv in (("export_tar", [handoff["stage1"], tar]),
                       ("tar_to_npz", [tar, back_nerf, "--netdepth", "8"]),
                       ("export_pt", [handoff["stage2"], pt]),
                       ("pt_to_npz", [pt, back_dfnet])):
        t = time.perf_counter()
        convert.main(argv)
        conv[name] = time.perf_counter() - t
    (n1, s1), (n2, s2) = load_pytree(handoff["stage1"]), load_pytree(back_nerf)
    (d1, _), (d2, _) = load_pytree(handoff["stage2"]), load_pytree(back_dfnet)
    want_nerf = {k: v for k, v in n1["params"].items() if k != "proposal"}
    if not (_same_leaves(n2["params"], want_nerf) and int(s1["global_step"]) ==
            int(s2["global_step"]) and "proposal" in n1["params"]):
        raise SystemExit("[tools] the stage-1 checkpoint does not come back from its .tar "
                         "bit for bit")
    if not _same_leaves(d2, d1):
        raise SystemExit("[tools] the stage-2 checkpoint does not come back from its .pt "
                         "bit for bit")
    out["convert_s"] = conv
    log(f"[tools] converters (main): s {json.dumps(conv)}; the .tar ({os.path.getsize(tar)} "
        f"bytes) and .pt ({os.path.getsize(pt)} bytes) convert back to the checkpoints' "
        f"leaves bit for bit (the .tar without the proposal net)")

    # --- FrozenNeRF from the .tar (stage 2's --ft_path)
    cfg2 = parse_args(feat_argv + ["--ft_path", tar], stage="feature")
    scene = load_scene(cfg2, stage="apr")
    tr = scene.train

    def frozen(path, *flags):
        cfg = parse_args(feat_argv + ["--ft_path", path, *flags], stage="feature")
        return FrozenNeRF.from_experiment(cfg, scene.hwf, scene.near, scene.far,
                                          scene.world_setup)

    nerf_tar = frozen(tar)
    if "proposal" in nerf_tar.params or not nerf_tar.uses_fast_render:
        raise SystemExit("[tools] the .tar FrozenNeRF holds a proposal net or takes the "
                         "plain path")
    rgb_tar = leg("tar_prerender", lambda: nerf_tar.prerender_views(tr.poses, tr.hists))
    nerf_npz = frozen(handoff["stage1"])
    del nerf_npz.params["proposal"]
    rgb_npz = leg("npz_noproposal_prerender",
                  lambda: nerf_npz.prerender_views(tr.poses, tr.hists))
    if not all(launches["tar_prerender"][k] > 0 for k in ("coarse_sigma_t", "fine_raw_t")):
        raise SystemExit(f"[tools] the .tar pre-render did not launch both sweeps: "
                         f"{launches['tar_prerender']}")
    if not np.array_equal(rgb_tar, rgb_npz):
        raise SystemExit("[tools] the .tar pre-render is not the proposal-less .npz's bit "
                         f"for bit: {float(np.abs(rgb_tar - rgb_npz).max())}")
    full_tar, full_npz = frozen(tar, "--tinyimg", "false", "--chunk", "16384"), \
        frozen(handoff["stage1"], "--tinyimg", "false", "--chunk", "16384")
    views = (0, len(tr) - 1)
    with torch.no_grad():
        got = torch.stack([full_tar.render_at_pose(tr.poses[i], tr.hists[i]) for i in views])
        want = torch.stack([full_tar.render_fn(
            full_tar.params, torch.as_tensor(tr.poses[i], device=device),
            torch.as_tensor(tr.hists[i], device=device)) for i in views])
    ok, agree = compare_rows(got, want, TOL_COMP)
    if not ok:
        raise SystemExit(f"[tools] the .tar kernel render disagrees with render_fn: {agree}")
    chunks = scene.H * scene.W / 16384
    chunk_ms = {k: cuda_ms(lambda n=n: n.render_at_pose(tr.poses[0], tr.hists[0]), 10) / chunks
                for k, n in (("tar_coarse_placement", full_tar),
                             ("npz_proposal_placement", full_npz))}
    out.update(agreement=agree, chunk_ms=chunk_ms)
    log(f"[tools] FrozenNeRF from the .tar: pre-render of {len(tr)} views of "
        f"{rgb_tar.shape[1:3]} (tinyimg) in {out['tar_prerender_s']:.3f} s, launches "
        f"{launches['tar_prerender']}, equal to the proposal-less .npz's bit for bit; "
        f"kernel vs plain render_fn at {scene.H}x{scene.W}: {json.dumps(agree)}; "
        f"ms a 16,384-ray chunk (CUDA events, {scene.H}x{scene.W} views): "
        f"{json.dumps(chunk_ms)}")

    # --- evaluation from the .pt
    evals = {}
    for stage, cli, argv in (("feature", feature_cli.train, feat_argv),
                             ("dm", dm_cli.main, dm_argv)):
        for tag, path in (("npz", handoff["stage2"]), ("pt", pt)):
            evals[f"{stage}_{tag}"] = np.asarray(
                cli(argv + ["--eval", "--pretrain_model_path", path])).tolist()
        if evals[f"{stage}_pt"] != evals[f"{stage}_npz"]:
            raise SystemExit(f"[tools] {stage} --eval from the .pt differs from the .npz: "
                             f"{evals}")
    axis = FeatureTrainer(parse_args(feat_argv + ["--pretrain_model_path", pt],
                                     stage="feature"), scene, None).triplet_axis
    if axis != triplet_axis(True):
        raise SystemExit(f"[tools] a stage-2 start from the .pt took triplet axis {axis}")
    out.update(evals=evals, pt_triplet_axis=axis)
    log(f"[tools] --eval [median, mean] from the .npz and the .pt: {json.dumps(evals)}; "
        f"a stage-2 start from the .pt takes triplet axis {axis} (the reference's, W)")

    # --- the spiral
    frames = []
    orig_write = nerf_cli.write_video

    def recording(path, f, *a):
        frames.append(f)
        return orig_write(path, f, *a)

    nerf_cli.write_video = recording
    try:
        spiral = leg("spiral", lambda: nerf_cli.train(nerf_argv + ["--render_pose_only"]))
    finally:
        nerf_cli.write_video = orig_write
    apng = png.read_apng(spiral)
    n = len(apng)
    first = (to8b(frames[0][0]) / 255.0).astype(np.float32)
    cfg1 = parse_args(nerf_argv, stage="nerf")
    sc1 = load_scene(cfg1, stage="nerf")
    if apng.shape[:3] != (120, sc1.H, sc1.W) or not np.array_equal(png.read_image(spiral),
                                                                   first):
        raise SystemExit(f"[tools] the spiral video {spiral} holds {apng.shape}, or its first "
                         "frame is not to8b of the first render")
    if any(launches["spiral"][k] != n for k in ("coarse_sigma_t", "fine_raw_t")):
        raise SystemExit(f"[tools] the spiral's launches {launches['spiral']} are not one "
                         f"of each sweep a frame")
    out["spiral"] = dict(frames=n, frames_per_s=n / out["spiral_s"],
                         bytes=os.path.getsize(spiral))
    log(f"[tools] --render_pose_only: {n} frames of {apng.shape[1:3]} in "
        f"{out['spiral_s']:.3f} s ({n / out['spiral_s']:.2f} frames/s, render and APNG), "
        f"{os.path.getsize(spiral)} bytes; launches {launches['spiral']}")

    # --- the split videos
    leg("videos", lambda: nerf_cli.train(nerf_argv + ["--render_test", "--render_video_train",
                                                        "--render_video_test"]))
    trainer = NeRFTrainer(cfg1, sc1)
    step = trainer.try_resume()
    exp = Path(base) / "nerfh"
    videos = {}
    for split, vid, pngdir in ((sc1.train, f"nerfh_trainset_{step:06d}_train",
                                f"evaluate_train_test_{step:06d}"),
                               (sc1.val, f"nerfh_test_{step:06d}_test",
                                f"evaluate_val_test_{step:06d}")):
        rgb = png.read_apng(str(exp / f"{vid}_rgb.png"))
        disp = png.read_apng(str(exp / f"{vid}_disp.png"))
        d = np.stack([trainer._render(trainer.params, torch.as_tensor(p, device=device),
                                      torch.as_tensor(h, device=device), step)["disp"]
                      .cpu().numpy() for p, h in zip(split.poses, split.hists)])
        ok = (len(rgb) == len(disp) == len(split)
              and all(np.array_equal(rgb[j], png.read_png(str(exp / pngdir / f"{j:03d}.png")))
                      for j in range(len(split)))
              and np.array_equal(disp[..., 0], to8b(d / max(d.max(), 1e-8))))
        if not ok:
            raise SystemExit(f"[tools] the {vid} videos do not hold the split's frames")
        videos[vid] = len(rgb)
    out["videos"] = videos
    log(f"[tools] --render_test --render_video_train --render_video_test: videos {videos} "
        f"(rgb frames equal the split PNGs, disp over the split max) in "
        f"{out['videos_s']:.3f} s; launches {launches['videos']}")

    # --- saliency maps
    cwd = os.getcwd()
    os.chdir(root)
    try:
        leg("saliency", lambda: feature_cli.train(
            feat_argv + ["--pretrain_model_path", handoff["stage2"], "--render_feature_only"]))
    finally:
        os.chdir(cwd)
    sal = {sub: sorted(os.listdir(root / "tmp" / "features" / sub)) for sub in ("target", "rgb")}
    if any(v != [f"{i:04d}.png" for i in range(len(tr))] for v in sal.values()):
        raise SystemExit(f"[tools] --render_feature_only wrote {sal}")
    log(f"[tools] --render_feature_only: {2 * len(tr)} PNGs in {out['saliency_s']:.3f} s; "
        f"launches {launches['saliency']}")

    # --- metrics and the trace
    hist = torch.as_tensor(sc1.val.hists[0], device=device)
    pose = torch.as_tensor(sc1.val.poses[0], device=device)
    renders = torch.stack([trainer._render(trainer.params, torch.as_tensor(p, device=device),
                                           torch.as_tensor(h, device=device), step)["rgb"]
                           for p, h in zip(sc1.val.poses, sc1.val.hists)])
    gt = torch.as_tensor(sc1.val.images, device=device)
    met = {}
    for name in ("ssim", "psnr"):
        card = float(getattr(metrics, name)(renders, gt))
        cpu = float(getattr(metrics, name)(renders.cpu(), gt.cpu()))
        met[name] = dict(card=card, cpu=cpu)
        if abs(card - cpu) > 1e-5:
            raise SystemExit(f"[tools] metrics.{name} on the card {card} vs the CPU {cpu}")
    trace_dir = root / "trace"
    with profiling.device_trace(str(trace_dir)):
        with profiling.annotate("render_view"):
            trainer._render(trainer.params, pose, hist, step)
            torch.cuda.synchronize()
    (trace,) = trace_dir.iterdir()
    names = {e.get("name", "") for e in json.loads(trace.read_text())["traceEvents"]}
    seen = {k: sorted(x for x in names if k in x) for k in ("coarse_sigma", "fine_raw")}
    if not all(seen.values()) or "render_view" not in names:
        raise SystemExit(f"[tools] the trace of one render does not name both kernels: {seen}")
    out.update(metrics=met, trace_kernels=seen)
    log(f"[tools] utils/metrics of {len(gt)} val renders, card / CPU: {json.dumps(met)}; "
        f"device_trace of one render names {json.dumps(seen)}")

    # --- --check_numerics on a NaN leaf: the fine net's rgb bias reaches the
    # loss on every path; a NaN in a hidden weight does not get past the
    # kernels' ReLU (fmaxf maps NaN to 0), so that leaf is reported only
    numerics = {}
    for tag, layer, idx in (("rgb_bias", "static_rgb", (0,)), ("hidden_w", "xyz_0", (0, 0))):
        tree, scalars = load_pytree(handoff["stage1"])
        leaf = tree["params"]["fine"][layer]["b" if tag == "rgb_bias" else "w"]
        leaf[idx] = np.nan
        nan_base = root / f"nan_{tag}"
        save_pytree(str(nan_base / "nerfh" / Path(handoff["stage1"]).name), tree,
                    global_step=int(scalars["global_step"]))
        argv = ["--config", str(cfgdir / "config_nerfh.txt"), "--basedir", str(nan_base),
                "--epochs", str(int(scalars["global_step"])), "--check_numerics"] + data
        try:
            nerf_cli.train(argv)
            numerics[tag] = "ran on"
        except FloatingPointError as e:
            numerics[tag] = f"FloatingPointError: {e}"
        if torch.is_anomaly_enabled():
            raise SystemExit("[tools] --check_numerics left anomaly mode on")
    if not numerics["rgb_bias"].startswith("FloatingPointError"):
        raise SystemExit(f"[tools] --check_numerics let a NaN weight train on: {numerics}")
    out["check_numerics"] = numerics
    log(f"[tools] --check_numerics with a NaN in fine/static_rgb/b and in fine/xyz_0/w: "
        f"{json.dumps(numerics)}")
    out["launches"] = launches
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dfnet_tpu_torch.ops import build

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    log(f"[card] {smi}")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.build_all()
    log(f"[build] {len(build.KERNEL_SOURCES)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in build.KERNEL_SOURCES:
        for line in build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {name}: {line.strip()}")

    def timed(phase, *a):
        t = time.perf_counter()
        out = phase(*a)
        log(f"[time] {phase.__name__}: {time.perf_counter() - t:.1f} s")
        return out

    cases = timed(phase_kernels, device)
    e2e_launches = timed(phase_e2e, device)
    render = timed(phase_render, device)
    mono = timed(phase_mono, device)
    frozen = timed(phase_frozen, device)
    probe = timed(phase_probe, device)
    cases += probe["cases"]
    train_result = timed(phase_train, device)
    with tempfile.TemporaryDirectory() as handoff:
        feature = timed(phase_feature, device, handoff)
        dm = timed(phase_dm, device, feature["best_ckpt"])
    seven = timed(phase_sevenscenes, device)
    handoff = seven.pop("handoff")
    try:
        tools = timed(phase_tools, device, handoff)
    finally:
        shutil.rmtree(handoff["root"], ignore_errors=True)
    cases += feature["cases"]

    # each kernel's row: its case on the main path it was ported for, and
    # the launches of every main path, each counted from 0 over its run
    main_case = {"coarse_sigma_t": ("nerfh_synthetic_301.npz", "exact", "render_test"),
                 "fine_raw_t": ("nerfh_synthetic_301.npz", "exact", "render_test"),
                 "fine_composite_t": ("nerfh_synthetic_301.npz", "culled",
                                      "render_culled"),
                 "raw_bwd_t": ("nerfh_synthetic_301.npz", "train-fine", "train"),
                 "proposal_z_rows": ("nerfh_synthetic_301.npz", "mono", "render_mono"),
                 "mlp_stack_bf16": ("probe data", "probe", "probe"),
                 "mlp_stack_int8": ("probe data", "probe", "probe")}
    empty = {k: 0 for k in REPLACES}
    path_launches = {"render_test": e2e_launches,
                     "render_culled": render["culled_fused"]["launches"],
                     "render_mono": mono["mono"]["launches"],
                     "frozen_prerender": {k: frozen["full"]["launches"][k]
                                          + frozen["tinyimg"]["launches"][k]
                                          for k in REPLACES},
                     "probe": {**empty, **probe["launches"]},
                     "train": train_result["launches"],
                     "feature": feature["launches"],
                     "dm": dm["launches"],
                     "sevenscenes": seven["launches"],
                     **{f"tools_{k}": v for k, v in tools["launches"].items()}}
    kernels = []
    for name, (asset, sched, path) in main_case.items():
        c = next(c for c in cases if c["name"] == name and c["asset"] == asset
                 and c["schedule"] == sched)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": path_launches[path][name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": None, "shape": c["shape"],
            "launches_by_path": {p: v[name] for p, v in path_launches.items()},
            "cases": [x for x in cases if x["name"] == name]})
    log(json.dumps({"render": {k: v["rays_per_s"] for k, v in render.items()}}))
    log(json.dumps({"mono": {k: {m: v[m] for m in ("rays_per_s", "val_psnr")}
                             for k, v in mono.items() if k != "agreement"}}))
    log(json.dumps({"frozen": frozen}))
    log(json.dumps({"probe": {W: {d: {m: o["run"][d][m] for m in ("marginal_ms", "rate")}
                                  for d in ("bf16", "int8")} | {"ratio": o["run"]["ratio"]}
                              for W, o in probe["widths"].items()}}))
    log(json.dumps({"train": train_result}))
    log(json.dumps({"feature": {k: v for k, v in feature.items() if k != "cases"}}))
    log(json.dumps({"dm": dm}))
    log(json.dumps({"sevenscenes": seven}))
    log(json.dumps({"tools": tools}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
