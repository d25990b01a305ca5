"""How closely DFNet and the stage-2 step must agree across devices,
packages and precisions: the one source of these bars and checks for
chip_smoke.py and the tests.

  - float32 (card against CPU, port against the JAX package): the bars of
    the JAX package's golden stage-2 step against its torch replica. Loss
    within 2e-4; each leaf's gradient within 2e-3 of its largest magnitude,
    except the conv5_3 branch's adapt convs (2e-2, 5e-2): two images'
    conv5_3 features are a small difference of large near-equal values,
    so float32 cancellation sets a ~1e-2 floor there. A gradient that is
    zero by construction (under freezeBN each adapt conv2 bias shifts both
    siamese streams alike and cancels in every distance) must stay below
    1e-6 on both sides. The port and the JAX package, both on the CPU, are
    held on every leaf; the card against the CPU on the leaves that golden
    test checks (GOLDEN_LEAVES). The card's float32 convs sum in another
    order than the CPU's, which flips a ReLU mask wherever a pre-activation
    lies within that rounding of zero, and one flipped element with a large
    cotangent moves its layer's gradient by up to a few percent of the
    scale (scripts/feature_diag.py counts the flips at these inputs).
  - the float32 eval forward (FeatureTrainer.predict, no grad), card
    against CPU: poses within 1e-4 of
    max(|pose|, 1), the float32 forwards' bar against the JAX package
    (tests/test_torch_port_dfnet.py).
  - stage 3 (the DM step, DMTrainer.loss_fn), float32: the same loss and
    gradient bars on F, card against CPU on the encoder and pose-head
    leaves of GOLDEN_LEAVES (DM_LEAVES), port against the JAX package on
    every leaf; F runs without its adapt branch, so those leaves get no
    gradient and must stay below ZERO_GRAD on both sides. dL/dpose is
    fc_pose/b's gradient (batch 1: the gradient of the 12 predicted pose
    entries, before the SVD projection). They are compared where F's
    predicted rotation block is near a rotation, with distinct singular
    values (dm_pose_bias), as a trained stage-2 net predicts. Card against
    CPU, those bars hold with the card rendering at the CPU's predicted
    pose (dm_loss_and_grads' render_pose); at its own pose, whose entries
    differ from the CPU's by float32 rounding, dL/dpose is held within
    DM_DPOSE_OWN_POSE of its scale, a bar set from the float64 gradient's
    largest move at such pose steps (scripts/dm_diag.py).
  - the stage-1 train step (culled or not), the kernel step against the
    plain step at bf16 matmul operands (bf16_model), or card against CPU
    (train_step_agreement), under the JAX package's fused-train bars (tests/test_fused_train.py,
    tests/test_culled_render.py:239-275): fine z within 2e-3, rgb0 / rgb /
    beta / acc within 5e-3, the loss within rtol 1e-3, every non-proposal
    gradient leaf within 3e-2 of its largest magnitude plus 3e-7 (the
    kernel sums bf16 products in another order, and at a fresh init the
    coarse grads are of bf16 rounding's size).
  - bf16 against float32 (the JAX package's tests/test_feature_bf16.py):
    pose within 5% of max(|pose|, 1); BN-normalised feature maps within
    0.08 mean absolute difference; the pose loss's gradient cosine above
    0.97 / 0.95 / 0.85 at conv5_3 / conv3_1 / conv1_1 and its norm within
    20% (bf16 rounding flips ReLU masks of a random-init net, and that
    compounds over 13 layers towards the input).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Tuple

import numpy as np
import torch

from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.models.dfnet import (
    DFNetConfig,
    conv_precision,
    dfnet_forward,
    dfnet_params_to_jax,
    init_dfnet_params,
)
from dfnet_tpu_torch.models.factory import create_nerfh
from dfnet_tpu_torch.ops.tolerances import TOL_Z
from dfnet_tpu_torch.training.checkpoints import save_pytree
from dfnet_tpu_torch.training.nerf_trainer import named_leaves

LOSS_TOL = 2e-4
GRAD_TOL = 2e-3
GRAD_TOL_LEAF = {"adapt/2/conv1/w": 2e-2, "adapt/2/conv2/w": 5e-2}
ZERO_GRAD = 1e-6
# the leaves tests/test_golden_e2e.py::test_stage2_rvs_step_golden holds
GOLDEN_LEAVES = ("encoder/conv1_1/w", "encoder/conv5_3/w", "encoder/conv5_3/b",
                 "adapt/0/conv1/w", "adapt/0/conv2/w", "adapt/2/conv1/w",
                 "adapt/2/conv2/w", "adapt/2/conv2/b", "fc_pose/w", "fc_pose/b")
EVAL_POSE_TOL = 1e-4
DM_LEAVES = tuple(k for k in GOLDEN_LEAVES if not k.startswith("adapt/"))
DM_POSE_SV = (1.15, 1.0, 0.85)
DM_DPOSE_OWN_POSE = 2e-2
# the DM step's NeRF and DFNet flags of the CPU parity tests
# (tests/test_torch_port_dm.py) and of the card-against-CPU checks
DM_FLAGS = ["--NeRFH", "--encode_hist", "--dataset_type", "synthetic", "--netdepth", "2",
            "--netwidth", "32", "--netdepth_fine", "2", "--netwidth_fine", "32",
            "--N_samples", "10", "--N_importance", "10", "--N_rand", "128",
            "--expname", "nerfh", "--model_name", "dfnetdm", "--DFNet", "--svd_reg",
            "--feature_precision", "fp32"]

TRAIN_Z_TOL = TOL_Z
TRAIN_OUT_TOL = 5e-3
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_TOL = 3e-2
TRAIN_GRAD_FLOOR = 3e-7
TRAIN_OUT_KEYS = ("rgb0", "rgb", "beta", "acc")

BF16_POSE = 0.05
BF16_FEATURE = 0.08
BF16_GRAD_COS = {"conv5_3": 0.97, "conv3_1": 0.95, "conv1_1": 0.85}
BF16_GRAD_NORM = 0.2

# the stage-2 config of the JAX package's golden step
# (tests/test_golden_e2e.py::test_stage2_rvs_step_golden), less its size
GOLDEN_FLAGS = ["--NeRFH", "--encode_hist", "--dataset_type", "synthetic", "--DFNet",
                "--tripletloss", "--freezeBN", "--random_view_synthesis",
                "--triplet_ref_axis", "True", "--triplet_margin", "1.0",
                "--combine_loss_w", "0.3,0.4,0.5", "--feature_precision", "fp32"]


def golden_batch():
    """The golden step's inputs, drawn as that test draws them: targets,
    renders, RVS views (4, 3, 32, 48) in [0, 1], poses and RVS poses (4, 12)."""
    g = torch.Generator().manual_seed(4)
    t, r, v = (torch.rand(4, 3, 32, 48, generator=g) for _ in range(3))
    poses, poses_p = torch.randn(4, 12, generator=g), torch.randn(4, 12, generator=g)
    return t, r, poses, v, poses_p


def loss_and_grads(trainer, batch) -> Tuple[float, Dict[str, np.ndarray]]:
    """The trainer's loss on `batch` (moved to its device) and the gradient
    of every param leaf, by path, as numpy; the params are left as they were."""
    batch = [b.to(trainer.device) for b in batch]
    for _, t in trainer._named:
        t.grad = None
    with conv_precision(trainer.compute_dtype):
        loss, _ = trainer.loss_fn(trainer.params, trainer.state, *batch)
        loss.backward()
    grads = {k: t.grad.cpu().numpy() for k, t in trainer._named}
    for _, t in trainer._named:
        t.grad = None
    return float(loss.detach()), grads


def golden_agreement(loss: float, grads: Dict[str, np.ndarray], ref_loss: float,
                     ref_grads: Dict[str, np.ndarray], leaves=None) -> Tuple[bool, Dict]:
    """The float32 bars on `leaves` (default: every leaf): (ok, {"loss_err",
    "grad_err": per-leaf relative error, "worst"})."""
    errs, ok = {}, abs(loss - ref_loss) < LOSS_TOL
    for k in leaves or ref_grads:
        want = ref_grads[k]
        scale = float(np.abs(want).max())
        if scale < ZERO_GRAD:
            errs[k] = float(np.abs(grads[k]).max())
            ok &= errs[k] < ZERO_GRAD
            continue
        errs[k] = float(np.abs(grads[k] - want).max()) / scale
        ok &= errs[k] < GRAD_TOL_LEAF.get(k, GRAD_TOL)
    worst = max(errs, key=lambda k: errs[k] / GRAD_TOL_LEAF.get(k, GRAD_TOL))
    return bool(ok), {"loss_err": abs(loss - ref_loss), "worst": worst,
                      "grad_err": errs}


def dm_pose_bias(pose: np.ndarray) -> np.ndarray:
    """A fc_pose/b (12,) that centres F's predictions on the (3, 4) `pose`,
    its rotation block scaled to singular values DM_POSE_SV. The SVD
    projection's backward has terms in 1/(s_i + s_j) and 1/(s_i - s_j): a
    random init's block has singular values near 0.05, where it magnifies
    float32 rounding some thirty times."""
    pose = np.asarray(pose, np.float64)
    rot = pose[:, :3] @ np.diag(DM_POSE_SV)
    return np.concatenate([rot, pose[:, 3:]], 1).reshape(12).astype(np.float32)


DM_WORLD = {"pose_scale": 0.8, "pose_scale2": 1.25, "move_all_cam_vec": [0.1, -0.05, 0.2]}


def dm_trainer(base: str, device, *flags, mesh=None):
    """A DMTrainer at DM_FLAGS (plus `flags`) on the 48x64 synthetic scene
    of 6 train and 3 val views under DM_WORLD, from seeded port inits that
    the first call writes under `base`: a NeRF-H checkpoint, and a DFNet
    one whose pose head is biased by dm_pose_bias. The same params on
    every device. `mesh`: the data mesh its renders split over (called on
    each of its ranks)."""
    from dfnet_tpu_torch.training.dm_trainer import DMTrainer
    from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF

    sc = make_synthetic_scene(n_train=6, n_val=3, H=48, W=64, focal=60.0, seed=0)
    sc.world_setup = DM_WORLD
    ckpt = os.path.join(base, "dfnet.npz")
    argv = DM_FLAGS + ["--basedir", base, "--pretrain_model_path", ckpt, *flags]
    if not os.path.exists(ckpt):
        _, nerf = create_nerfh(parse_args(argv), torch.Generator().manual_seed(0))
        save_pytree(os.path.join(base, "nerfh", "000005.npz"), {"params": nerf})
        params, state = init_dfnet_params(torch.Generator().manual_seed(1))
        params["fc_pose"]["b"] = torch.tensor(dm_pose_bias(sc.train.poses[0]))
        params, state = dfnet_params_to_jax(params, state)
        save_pytree(ckpt, {"params": params, "state": state})
    cfg = parse_args(argv + ["--device", str(device)], stage="dm")
    nerf = FrozenNeRF.from_experiment(cfg.replace(tinyimg=True, tinyscale=4.0), sc.hwf,
                                      sc.near, sc.far, sc.world_setup, mesh=mesh)
    return DMTrainer(cfg, sc, nerf)


def dm_loss_and_grads(trainer, image, pose12, hist,
                      render_pose=None) -> Tuple[float, float, Dict, np.ndarray]:
    """The DM trainer's (loss, psnr) on one image (H, W, 3) with its
    (1, 12) pose and hist, moved to its device, the gradient of every leaf
    of F by path as numpy (zeros where autograd gives none), and F's
    predicted (3, 4) pose; the params are left as they were.

    render_pose: a (3, 4) value to render at in place of the predicted
    pose, the gradient still flowing into F through the predicted one. The
    DM gradient is not smooth in the pose: a float64 run's dL/dpose moves
    by up to 0.8% of its scale when the pose moves by 1e-7, below float32's
    rounding of it (scripts/dm_diag.py), so two devices' float32 steps are
    compared at one render pose. On a mesh the grads are averaged over its
    ranks, as the trainer's step averages them."""
    args = [torch.as_tensor(a).to(trainer.device) for a in (image, pose12, hist)]
    seen, render = {}, trainer.render

    def pinned(params, poses, hists):
        seen["pose"] = poses.detach()[0].cpu().numpy()
        if render_pose is not None:
            pin = torch.as_tensor(render_pose, dtype=poses.dtype, device=poses.device)
            poses = poses + (pin - poses).detach()
        return render(params, poses, hists)

    for _, t in trainer._named:
        t.grad = None
    trainer.render = pinned
    try:
        with conv_precision(trainer.compute_dtype):
            loss, psnr = trainer.loss_fn(trainer.params, trainer.nerf.params,
                                         trainer.feat_params, *args)
            loss.backward()
        trainer.reduce_grads()
    finally:
        trainer.render = render
    grads = {k: (t.grad if t.grad is not None else torch.zeros_like(t)).cpu().numpy()
             for k, t in trainer._named}
    for _, t in trainer._named:
        t.grad = None
    return float(loss.detach()), float(psnr.detach()), grads, seen["pose"]


def dm_agreement(loss: float, grads: Dict[str, np.ndarray], ref_loss: float,
                 ref_grads: Dict[str, np.ndarray], leaves=None) -> Tuple[bool, Dict]:
    """The float32 bars of a DM step on `leaves` (default: every leaf),
    and F's adapt leaves below ZERO_GRAD on both sides: (ok, info), info
    as golden_agreement's plus "adapt_max" (both sides' largest entry)."""
    adapt = [k for k in ref_grads if k.startswith("adapt/")]
    ok, info = golden_agreement(loss, grads, ref_loss, ref_grads,
                                leaves=(list(leaves) + adapt) if leaves else None)
    info["adapt_max"] = max(float(np.abs(g[k]).max()) for g in (grads, ref_grads)
                            for k in adapt)
    return bool(ok and info["adapt_max"] < ZERO_GRAD), info


def eval_agreement(pose: torch.Tensor, ref: torch.Tensor) -> Tuple[bool, float]:
    """The eval forward's bar: (ok, largest |pose - ref|) for (B, 12) poses."""
    err = float((pose.cpu() - ref.cpu()).abs().max())
    return err < EVAL_POSE_TOL * max(float(ref.abs().max()), 1.0), err


def bf16_agreement(params: Dict, state: Dict, x: torch.Tensor,
                   cfg: DFNetConfig = DFNetConfig()) -> Tuple[bool, Dict]:
    """bf16 against float32 on x's device: a single-stream train-BN forward
    (features upsampled to x's size, pose) and the gradient of mean(pose²)
    through an eval-BN pose forward, held to the bf16 bars."""
    h, w = x.shape[-2:]
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        with torch.no_grad():
            feats, pose, _ = dfnet_forward(params, state, x, cfg, return_feature=True,
                                           is_single_stream=True, upsample_h=h,
                                           upsample_w=w, train_bn=True, compute_dtype=dt)
        p = {k: {n: t.detach().clone().requires_grad_() for n, t in v.items()}
             for k, v in params["encoder"].items()}
        named = dict(named_leaves(p))
        with conv_precision(dt):
            _, pose_g, _ = dfnet_forward({**params, "encoder": p}, state, x, cfg,
                                         compute_dtype=dt)
            torch.mean(pose_g ** 2).backward()
        out[dt] = (feats[0], pose, {k: named[f"{k}/w"].grad.flatten()
                                    for k in BF16_GRAD_COS})
    (f32, p32, g32), (fbf, pbf, gbf) = out[torch.float32], out[torch.bfloat16]
    pose_err = float((pbf - p32).abs().max())
    pose_bar = BF16_POSE * max(float(p32.abs().max()), 1.0)
    feat_err = float((fbf.float() - f32).abs().mean())
    info = {"pose_err": pose_err, "pose_bar": pose_bar, "feature_err": feat_err,
            "dtypes": [str(fbf.dtype), str(pbf.dtype)], "grad": {}}
    ok = (pose_err < pose_bar and feat_err < BF16_FEATURE and fbf.dtype == torch.bfloat16
          and pbf.dtype == torch.float32
          and all(g.dtype == torch.float32 for g in gbf.values()))
    for k, min_cos in BF16_GRAD_COS.items():
        a, b = g32[k].double(), gbf[k].double()
        na, nb = float(a.norm()), float(b.norm())
        cos = float(a @ b) / (na * nb + 1e-30)
        info["grad"][k] = {"cos": cos, "norm_ratio": nb / max(na, 1e-30)}
        ok &= cos > min_cos and abs(nb - na) < BF16_GRAD_NORM * na
    return bool(ok), info


# The vanilla NeRF's render, card against CPU in float32 with TF32 off: the
# coarse pass and the fine pass over the same (the card's) samples within
# VANILLA_STAGE_TOL; the fine z that sample_pdf draws from the same (the
# card's) coarse weights within the fine-z bar TOL_Z (the two devices'
# cumulative sums differ by float32 rounding, and the inverse CDF divides
# by small CDF steps: 7.6e-4 on the card at the trained checkpoint of
# chip_smoke.py's phase_models); the whole render at the repo's
# rendered-rgb bar, since past the sampler float32 rounding moves the fine
# samples, as it moves JAX's float32 render against a float64 one by up to
# 1e-2 on a random net (tests/test_torch_port_vanilla.py, RENDER_BARS).
VANILLA_STAGE_TOL = 1e-4
VANILLA_RENDER_TOL = 3e-2


@contextlib.contextmanager
def no_tf32():
    """Matmuls and cuDNN convolutions in IEEE float32 inside the block (cuDNN
    stays on, unlike models/dfnet.py::conv_precision)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def vanilla_render_agreement(params: Dict, model, rays_o: torch.Tensor,
                             rays_d: torch.Tensor, settings, device) -> Tuple[bool, Dict]:
    """(ok, the largest |card - CPU| of each stage and of the whole render)
    for a vanilla pair at deterministic settings (perturb 0, no noise).
    params, rays_o and rays_d lie on the CPU."""
    from dfnet_tpu_torch.models.layers import tree_to
    from dfnet_tpu_torch.render.sampling import sample_pdf, stratified_z_vals
    from dfnet_tpu_torch.render.volume import render_rays_vanilla, vanilla_pass

    if settings.perturb != 0.0 or settings.raw_noise_std != 0.0:
        raise ValueError("the vanilla render agreement needs perturb 0 and no noise")
    dev = torch.device(device)
    cpu = torch.device("cpu")
    args = {d: (tree_to(params, d), rays_o.to(d), rays_d.to(d)) for d in (cpu, dev)}
    keys = ("rgb", "acc", "depth")
    err = lambda a, b: float((a.to(cpu) - b.to(cpu)).abs().max())
    with no_tf32(), torch.no_grad():
        full = {d: render_rays_vanilla(p, model, ro, rd, settings)
                for d, (p, ro, rd) in args.items()}
        coarse, z_fine, fine = {}, {}, {}
        n = rays_o.shape[0]
        z = stratified_z_vals(torch.full((n, 1), settings.near),
                              torch.full((n, 1), settings.far), settings.N_samples)
        for d, (p, ro, rd) in args.items():
            vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
            dir_emb = model.embed_dir(vd)
            coarse[d] = vanilla_pass(p["coarse"], model.cfg_coarse, model.embed_xyz,
                                     ro, rd, z.to(d), dir_emb, settings)
        w = coarse[dev]["weights"][..., 1:-1]
        z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
        for d in (cpu, dev):
            z_fine[d] = sample_pdf(z_mid.to(d), w.to(d), settings.N_importance, det=True)
        z_all = torch.sort(torch.cat([z.to(dev), z_fine[dev]], -1), -1).values
        for d, (p, ro, rd) in args.items():
            vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
            fine[d] = vanilla_pass(p["fine"], model.cfg_fine, model.embed_xyz, ro, rd,
                                   z_all.to(d), model.embed_dir(vd), settings)
    info = {"coarse": max(err(coarse[dev][k], coarse[cpu][k]) for k in keys),
            "fine_z": err(z_fine[dev], z_fine[cpu]),
            "fine_pass": max(err(fine[dev][k], fine[cpu][k]) for k in keys),
            "render": max(err(full[dev][k], full[cpu][k]) for k in ("rgb", "acc"))}
    ok = (max(info["coarse"], info["fine_pass"]) <= VANILLA_STAGE_TOL
          and info["fine_z"] <= TOL_Z and info["render"] <= VANILLA_RENDER_TOL)
    return ok, info


# The backbone zoo, card against CPU in float32 with TF32 off: each output
# within the CPU tests' bar (tests/test_torch_port_zoo*.py) times its largest
# magnitude. The CPU tests' outputs are of order 1; a random-init zoo net's
# range from 3e-7 (MobileNetV2's block-17 tap) to about 240 (ResNet34's
# pose), so the bar scales with each.
ZOO_BARS = {"posenetv2": 3e-4, "efficientnet_b0": 2e-3, "efficientnet_b3": 3e-3,
            "resnet34_posenet": 3e-4, "mapnet": 3e-4,
            **{f"autoencoder_vgg{v}": 1e-4 for v in range(1, 8)}}


def zoo_model(name: str, gen: torch.Generator):
    """(params, state, forward) of a zoo family at its published layout,
    params drawn from `gen` on the CPU; forward(params, state, x) returns
    the list of its output tensors. x is (B, 3, H, W) RGB in [0, 1]
    ((N, T, 3, H, W) for mapnet; autoencoder_vgg6/7 pool their features to
    a quarter of the input's sides)."""
    from dfnet_tpu_torch.models import autoencoder as ae
    from dfnet_tpu_torch.models import efficientnet as eff
    from dfnet_tpu_torch.models import mobilenet as mob
    from dfnet_tpu_torch.models import resnet as res

    if name == "posenetv2":
        def posenet(p, s, x):
            feats, pose, _ = mob.posenetv2_forward(p, s, x, is_train=True,
                                                   is_single_stream=True)
            return [feats[0], pose]
        return (*mob.init_posenetv2_params(gen), posenet)
    if name.startswith("efficientnet_"):
        cfg = eff.EfficientNetAPRConfig(variant=name.split("_")[1])
        p, s = eff.init_efficientnet_apr(gen, cfg)
        return p, s, lambda p, s, x: [eff.efficientnet_apr_forward(p, s, x, cfg)[0]]
    if name in ("resnet34_posenet", "mapnet"):
        cfg = res.LegacyPoseNetConfig(mapnet_heads=name == "mapnet")
        p, s = res.init_legacy_posenet(gen, cfg)
        fwd = res.mapnet_forward if name == "mapnet" else res.legacy_posenet_forward
        return p, s, lambda p, s, x: [fwd(p, s, x, cfg)[0]]
    v = int(name[-1])
    p = getattr(ae, f"init_autoencoder_vgg{v}")(gen)
    fwd = getattr(ae, f"autoencoder_vgg{v}")

    def forward(p, s, x):
        extra = (x.shape[-2] // 4, x.shape[-1] // 4) if v in (6, 7) else ()
        out = []
        for o in fwd(p, 2 * x - 1, *extra):
            out += [] if o is None else (o if isinstance(o, list) else [o])
        return out
    return p, {}, forward


def zoo_agreement(name: str, x: torch.Tensor, device, seed: int = 0) -> Tuple[bool, float]:
    """(ok, the largest |card - CPU| / (bar * scale) over the outputs) of a
    zoo family's float32 forward on x (CPU), TF32 off."""
    from dfnet_tpu_torch.models.layers import tree_to

    params, state, forward = zoo_model(name, torch.Generator().manual_seed(seed))
    with no_tf32(), torch.no_grad():
        want = forward(params, state, x)
        got = forward(tree_to(params, device), tree_to(state, device), x.to(device))
    ratio = 0.0
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-30)
        ratio = max(ratio, float((g.cpu() - w).abs().max()) / (ZOO_BARS[name] * scale))
    return len(got) == len(want) and ratio <= 1.0, ratio


def _trainable_copy(tree, device):
    if isinstance(tree, dict):
        return {k: _trainable_copy(v, device) for k, v in tree.items()}
    return tree.detach().to(device).clone().requires_grad_(True)


def bf16_model(model):
    """A NeRF-H model description whose plain render takes bf16 matmul
    operands (its nets' compute_dtype), the kernel step's precision: the
    JAX package holds its fused train step to its plain step at
    --precision bf16 (tests/test_culled_render.py::_train_setup)."""
    bf = lambda c: None if c is None else dataclasses.replace(c, compute_dtype=torch.bfloat16)
    return dataclasses.replace(model, cfg_coarse=bf(model.cfg_coarse),
                               cfg_fine=bf(model.cfg_fine),
                               cfg_proposal=bf(model.cfg_proposal))


def train_step(params: Dict, model, cfg, settings, rays_o: torch.Tensor,
               rays_d: torch.Tensor, target: torch.Tensor, hist: torch.Tensor,
               fused: bool) -> Tuple[float, Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(loss, render outputs, grads by leaf path) of one stage-1 step on the
    inputs' device: the kernel step (`fused`) or the plain one, at
    deterministic settings (perturb 0, no sigma noise), from a copy of
    `params` (a tree of detached tensors) on that device."""
    from dfnet_tpu_torch.render.fused_train import render_rays_train_fused
    from dfnet_tpu_torch.render.volume import render_rays
    from dfnet_tpu_torch.training.nerf_trainer import stage1_loss

    if settings.perturb != 0.0 or settings.raw_noise_std != 0.0:
        raise ValueError("the train-step agreement needs perturb 0 and no noise")
    p = _trainable_copy(params, rays_o.device)
    render = render_rays_train_fused if fused else render_rays
    with torch.no_grad():
        out = render(p, model, rays_o, rays_d, hist, settings, None)
    loss, _ = stage1_loss(p, model, cfg, settings, rays_o, rays_d, target, hist, None,
                          fused)
    loss.backward()
    grads = {k: (t.grad if t.grad is not None else torch.zeros_like(t)).float().cpu().numpy()
             for k, t in named_leaves(p)}
    return (float(loss.detach()), {k: v.float().cpu().numpy() for k, v in out.items()},
            grads)


def train_step_agreement(got: Tuple, want: Tuple) -> Tuple[bool, Dict]:
    """(ok, each bar's worst ratio, < 1 passes) of two train_step results
    under the fused-train bars: z_all, the outputs, the loss and every
    non-proposal leaf's gradient."""
    (gl, go, gg), (wl, wo, wg) = got, want
    info = {"z_all": float(np.abs(go["z_all"] - wo["z_all"]).max()) / TRAIN_Z_TOL,
            "outputs": max(float(np.abs(go[k] - wo[k]).max())
                           for k in TRAIN_OUT_KEYS) / TRAIN_OUT_TOL,
            "loss": abs(gl - wl) / (TRAIN_LOSS_RTOL * abs(wl))}
    worst, leaf = 0.0, ""
    for k, w in wg.items():
        if k.startswith("proposal/"):
            continue
        g, w = np.asarray(gg[k], np.float64), np.asarray(w, np.float64)
        scale = max(np.abs(g).max(), np.abs(w).max())
        r = float(np.abs(g - w).max()) / (TRAIN_GRAD_TOL * scale + TRAIN_GRAD_FLOOR)
        if r >= worst:
            worst, leaf = r, k
    info.update(grads=worst, worst_leaf=leaf, n_fine=int(go["z_all"].shape[-1]))
    ok = (sorted(gg) == sorted(wg) and go["z_all"].shape == wo["z_all"].shape
          and all(info[k] < 1 for k in ("z_all", "outputs", "loss", "grads"))
          and all(np.isfinite(v).all() for v in gg.values()))
    return ok, info
