"""Stage-3 DFNet_dm steps, driven as DMTrainer.train_epoch drives them:
one image a step (dm_batch_size 1) in the epoch's shuffled order, each
index handed to the device as the trainer hands it, and a sync only where
an epoch ends (the epoch's mean loss). No eval_epoch.

Set-up makes a synthetic test sequence from the seed (the analytic
field's frames and histograms), writes DFNet's seeded init (the pose
model F, and the feature model G, the same weights) as a checkpoint in a
temporary directory for the trainer to load, renders through FrozenNeRF
on the configuration's trained NeRF asset at 1/4 size (the stage-3 CLI's
tinyimg), and runs the first `check_steps` steps through the window's own
call. Each call of the trainer's own `DMTrainer.render` is wrapped from
here: CUDA events around it (dm_render_ms) and, on the checked steps, the
pose it renders at and the gradient the loss sends back to that pose.

The check holds those steps to the reference at one render pose (the DM
gradient is rough in the pose below float32's rounding of it): F's raw
pose (captured, on the checked steps, where predict_poses hands it to the
SVD projection) against the reference's F; at the program's render pose, the loss and
dL/dpose against the reference's render, G and loss; the first gradient
into F (from the Adam state it leaves) against the reference's chain of
that dL/dpose through its F; and the parameters after the checked steps.

The workload file gives: H, W, focal; frames; appearance_jitter;
check_steps; warmup_steps; launches_per_step; check (limits). The
configuration's `stage3` group holds config_dfnetdm.txt's settings.
"""

from __future__ import annotations

import math
import os
import shutil
import statistics
import tempfile
import time
from typing import Dict, List

import numpy as np

from benchmark import harness
from benchmark.generators.common import Marks, check_launches, program_flags, scene_data
from benchmark.frozen import PEAK_BF16, PEAK_F32, point_flops
from benchmark.scene import (FAR, NEAR, frames_and_hists, leaves, load_npz_tree,
                             make_blob_field, pixel_rays, sphere_poses, tree_map, tree_of)

ADAM_B1 = 0.9
NOUGHT_GRAD = 1e-3
TAPS = (("conv1_2", 64), ("conv3_3", 256), ("conv5_3", 512))
VGG16 = [("conv1_1", 3, 64), ("conv1_2", 64, 64), ("conv2_1", 64, 128),
         ("conv2_2", 128, 128), ("conv3_1", 128, 256), ("conv3_2", 256, 256),
         ("conv3_3", 256, 256), ("conv4_1", 256, 512), ("conv4_2", 512, 512),
         ("conv4_3", 512, 512), ("conv5_1", 512, 512), ("conv5_2", 512, 512),
         ("conv5_3", 512, 512)]
POOL_AFTER = {"conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3"}


def init_dfnet(gen, device):
    """DFNet's seeded (params, state) in the JAX package's layout: HWIO
    convs at torch.nn.Conv2d's uniform bound, BatchNorm at identity, the
    pose head at torch.nn.Linear's; one draw for every weight and bias."""
    import torch

    convs = [(f"encoder/{n}", 3, 3, ci, co) for n, ci, co in VGG16]
    for i, (_, c) in enumerate(TAPS):
        convs += [(f"adapt/{i}/conv1", 1, 1, c, 64), (f"adapt/{i}/conv2", 5, 5, 64, 128)]
    sizes = [kh * kw * ci * co + co for _, kh, kw, ci, co in convs] + [512 * 12 + 12]
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    items, off = [], 0
    for path, kh, kw, ci, co in convs:
        bound = 1.0 / math.sqrt(kh * kw * ci)
        items.append((path + "/w", u[off:off + kh * kw * ci * co].view(kh, kw, ci, co) * bound))
        off += kh * kw * ci * co
        items.append((path + "/b", u[off:off + co] * bound))
        off += co
    params = tree_of(items)
    bound = 1.0 / math.sqrt(512)
    params["fc_pose"] = {"w": u[off:off + 512 * 12].view(512, 12) * bound,
                         "b": u[off + 512 * 12:off + 512 * 12 + 12] * bound}
    state = {"adapt": {}}
    for i in range(len(TAPS)):
        params["adapt"][str(i)].update(bn_scale=torch.ones(128, device=device),
                                       bn_bias=torch.zeros(128, device=device))
        state["adapt"][str(i)] = {"mean": torch.zeros(128, device=device),
                                  "var": torch.ones(128, device=device)}
    return params, state


def write_checkpoint(path: str, params: Dict, state: Dict) -> None:
    """The packages' flat npz checkpoint of {"params", "state"}."""
    flat = {f"tree/params/{p}": t.cpu().numpy() for p, t in leaves(params)}
    flat.update({f"tree/state/{p}": t.cpu().numpy() for p, t in leaves(state)})
    np.savez(path, **flat)


def conv_flops(H: int, W: int, upto: str = "conv5_3") -> List[float]:
    """Forward FLOPs of VGG16's convs on one H x W image, in order, up to
    and including `upto`."""
    out = []
    for n, ci, co in VGG16:
        out.append(2.0 * H * W * ci * co * 9)
        if n == upto:
            break
        if n in POOL_AFTER:
            H, W = H // 2, W // 2
    return out


class Cell:
    unit = "step"

    def __init__(self, cfg: Dict, wl: Dict, seed: int, device: str):
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.trace = None
        self.failed = 0
        self.tmp = None

    # ------------------------------------------------------------ set-up
    def make_inputs(self) -> None:
        import torch

        c, w = self.cfg, self.wl
        H, W, f, n = w["H"], w["W"], w["focal"], w["frames"]
        rng = np.random.default_rng(self.seed)
        field_seed, self.rng_seed, init_seed = (int(x) for x in rng.integers(0, 2**31 - 1, 3))
        self.poses = sphere_poses(n, rng)
        jit = w["appearance_jitter"]
        self.frames, self.hists = frames_and_hists(
            make_blob_field(field_seed), self.poses, H, W, f, 1.0 + rng.uniform(-jit, jit, n),
            self.device, c["hist_bin"])
        gen = torch.Generator(device=self.device).manual_seed(init_seed)
        self.dfnet, self.dfnet_state = init_dfnet(gen, self.device)
        self.asset = load_npz_tree(str(harness.ROOT / c["asset"]))
        ts = c["stage3"]["tinyscale"]
        self.tiny = (H // ts, W // ts, f / ts)

    def setup(self) -> None:
        import torch

        from dfnet_tpu_torch.config import parse_args
        from dfnet_tpu_torch.ops import nerf_kernels as nk
        from dfnet_tpu_torch.training.dm_trainer import DMTrainer
        from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF

        c, w = self.cfg, self.wl
        self.marks = mark = Marks()
        self.make_inputs()
        mark("inputs")
        self.tmp = tempfile.mkdtemp(prefix="dfnet_bench_dm_")
        ckpt = os.path.join(self.tmp, "dfnet_init.npz")
        write_checkpoint(ckpt, self.dfnet, self.dfnet_state)
        mark("checkpoint")
        scene = scene_data(self.frames, self.poses, self.hists, w["H"], w["W"], w["focal"],
                           NEAR, FAR)
        argv = (program_flags(c) + program_flags(c["stage3"])
                + ["--pretrain_model_path", ckpt, "--basedir", self.tmp,
                   "--rng_seed", str(self.rng_seed), "--device", self.device])
        self.pcfg = parse_args(argv, stage="dm")
        # the stage-3 CLI renders at a quarter of the size (cli/dm.py::_setup)
        nerf_cfg = self.pcfg.replace(tinyimg=True, tinyscale=float(c["stage3"]["tinyscale"]))
        params = tree_map(lambda a: torch.as_tensor(a, device=self.device), self.asset)
        nerf = FrozenNeRF(nerf_cfg, scene.hwf, NEAR, FAR, scene.world_setup, params=params,
                          device=self.device)
        self.tr = DMTrainer(self.pcfg, scene, nerf, device=self.device)
        self._wrap_render()
        self.order_rng = np.random.default_rng(self.pcfg.rng_seed)
        self.order: List[int] = []
        self.epoch_losses: List = []
        self.images, self.poses12, self.hists_d = self.tr.train_data
        mark("trainer")

        self.params0 = {p: t.detach().clone() for p, t in self.named()}
        before = dict(nk.LAUNCHES)
        self.capture = True
        self._capture_raw_poses(True)
        self.checked = []
        try:
            for k in range(w["check_steps"]):
                self.checked.append(self.step())
                if k == 0:
                    self.grad1 = self.first_gradient()
        finally:
            self._capture_raw_poses(False)
        self.params3 = {p: t.detach().clone() for p, t in self.named()}
        self.capture = False
        if self.device != "cpu":
            check_launches(before, nk.LAUNCHES, w["launches_per_step"], w["check_steps"],
                           "the checked steps")
        for _ in range(w["warmup_steps"]):
            self.step()
        mark("checked and warm-up steps")
        self._work()

    def _capture_raw_poses(self, on: bool) -> None:
        """On the checked steps, F's raw pose (before the SVD projection,
        whose output swings with an untrained F's near-singular rotation
        block) as predict_poses hands it to the projection."""
        from dfnet_tpu_torch.training import dm_trainer

        if on:
            self._svd = orig = dm_trainer.project_rotation_svd

            def svd(pose):
                self.raw.append(pose.detach().clone())
                return orig(pose)
            dm_trainer.project_rotation_svd = svd
        else:
            dm_trainer.project_rotation_svd = self._svd

    def _wrap_render(self) -> None:
        """CUDA events around each call of the trainer's render; on the
        checked steps, its pose and the gradient that reaches it."""
        import torch

        tr, orig = self.tr, self.tr.render
        self.events, self.seen, self.raw = [], [], []
        timed = self.device != "cpu"

        def render(nerf_params, poses, hists):
            if self.capture:
                grads: List = []
                poses.register_hook(grads.append)
                self.seen.append((poses.detach().clone(), grads))
            if not timed:
                return orig(nerf_params, poses, hists)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = orig(nerf_params, poses, hists)
            e1.record()
            self.events.append((e0, e1))
            return out
        tr.render = render

    def named(self):
        from dfnet_tpu_torch.training.nerf_trainer import named_leaves

        return named_leaves(self.tr.params)

    def first_gradient(self) -> Dict:
        import torch

        st = self.tr.optimizer.state
        return {p: st[t]["exp_avg"].detach() / (1.0 - ADAM_B1) if "exp_avg" in st.get(t, {})
                else torch.zeros_like(t) for p, t in self.named()}

    def step(self):
        """One train_step on the next image of the epoch; (frame, loss)."""
        import torch

        if not self.order:
            if self.epoch_losses:     # the epoch's end: train_epoch reads its mean
                float(torch.cat(self.epoch_losses).mean())
            self.epoch_losses = []
            self.order = [int(i) for i in self.order_rng.permutation(len(self.poses))]
        i = self.order.pop(0)
        idx = torch.as_tensor(np.array([i]), device=self.device)
        losses, _ = self.tr.train_step(self.images[idx], self.poses12[idx], self.hists_d[idx])
        self.epoch_losses.append(losses)
        return i, losses

    def _work(self) -> None:
        """Operations of a step: the render's float32 MLP sweeps (the
        coarse net's placement forward, the fine net's forward and its
        input-gradient backward: the NeRF's weights are frozen) and
        DFNet's bf16 convs (F forward and backward, G's encoder to conv5_3
        and adapt convs forward, and its backward from the loss's level-0
        feature of the render to the input)."""
        c, w = self.cfg, self.wl
        rh, rw, _ = self.tiny
        rays = rh * rw
        in_x = 3 + 6 * c["multires"]
        coarse = point_flops(c["netdepth"], c["netwidth"], c["skips"][0], in_x, kind="sigma")
        fine = point_flops(c["netdepth_fine"], c["netwidth_fine"], c["skips"][0], in_x)
        S, Sf = c["N_samples"], c["N_samples"] + c["N_importance"]
        render = rays * (S * coarse + 2 * Sf * fine)
        H, W = w["H"], w["W"]
        enc = conv_flops(H, W)
        f_enc = sum(enc)
        adapt, h, wd = 0.0, H, W
        hw = {}
        for n, ci, co in VGG16:
            hw[n] = (h, wd, co)
            if n in POOL_AFTER:
                h, wd = h // 2, wd // 2
        for tap, _ in TAPS:
            th, tw, tc = hw[tap]
            adapt += 2.0 * th * tw * (tc * 64 + 64 * 128 * 25)
        lvl0 = 2.0 * H * W * (64 * 64 + 64 * 128 * 25)
        # F: forward, input grads (none into the image) and weight grads;
        # G on two images to conv5_3 with its adapts, backward to the render
        dfnet = 3 * f_enc - enc[0] + 2 * (f_enc + adapt) + (enc[0] + enc[1] + lvl0)
        self.ops_per_unit = [(render, PEAK_F32), (dfnet, PEAK_BF16)]
        self.kernels = {}

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> None:
        import torch

        self.events = []
        t0 = time.perf_counter()
        end, now, steps = t0 + seconds, t0, 0
        while now < end:
            self.step()
            steps += 1
            now = time.perf_counter()
        if self.device != "cpu":
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - t0
        self.units = self.attempted = steps
        self.render_ms = (statistics.fmean(a.elapsed_time(b) for a, b in self.events)
                          if self.events else None)

    def end_to_end(self) -> Dict[str, float]:
        return {"dm_images_per_s": self.units / self.window_s}

    def release(self) -> None:
        import torch

        self.out = {"losses": [float(l[0]) for _, l in self.checked],
                    "poses": [p[0].cpu() for p, _ in self.seen],
                    "raw": [p[0].cpu() for p in self.raw],
                    "dpose": [g[0][0].cpu() if g else None for _, g in self.seen],
                    "grad1": {p: g.cpu() for p, g in self.grad1.items()},
                    "params3": {p: t.cpu() for p, t in self.params3.items()},
                    "params0": {p: t.cpu() for p, t in self.params0.items()}}
        del self.tr
        if self.tmp:
            shutil.rmtree(self.tmp, ignore_errors=True)
        if self.device != "cpu":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def reference_steps(self, render_poses=None, precision=("fp32", "fp32"), fault=""):
        """The reference's view of the checked steps: {"losses", "poses",
        "dpose", "grad1", "params3"}. Each step renders at render_poses[k]
        (the program's), or, where None, at its own F's pose (the reference
        in the program's place). precision: (DFNet convs, render matmuls).
        fault "answer_altered": the render's rgb out by 0.05."""
        import torch

        from benchmark import reference_dfnet as rdf
        from benchmark import reference_nerfh as ref

        c, w, dev = self.cfg, self.wl, self.device
        rh, rw, rf = self.tiny
        conv, mm = rdf.Conv(precision[0]), ref.Matmul(precision[1])
        sizes = dict(c, near=NEAR, far=FAR)
        nerf = tree_map(lambda a: torch.as_tensor(a, device=dev), self.asset)
        paths = [p for p, _ in leaves(self.dfnet)]
        leaves_f = [t.detach().clone().requires_grad_(True) for _, t in leaves(self.dfnet)]
        F = tree_of(zip(paths, leaves_f))
        out = {"losses": [], "poses": [], "raw": [], "dpose": []}
        state: Dict = {}
        with ref.float32_matmuls():
            for k, (i, _) in enumerate(self.checked):
                image = torch.as_tensor(self.frames[i], device=dev)
                hist = torch.as_tensor(self.hists[i], device=dev)
                raw_f, pose_f = rdf.pose(F, image, conv)
                at = pose_f.detach() if render_poses is None else render_poses[k].to(dev)
                at = at.clone().requires_grad_(True)
                ro, rd = pixel_rays(rh, rw, rf, at)
                rgb = ref.render_rays(nerf, sizes, {"placement": "coarse"}, ro, rd, hist,
                                      mm)["rgb"]
                if fault == "answer_altered":
                    rgb = rgb + 0.05
                up = rdf.upsample_bicubic(rgb.reshape(rh, rw, 3), w["H"], w["W"])
                feats = rdf.level0_features(self.dfnet, self.dfnet_state,
                                            torch.stack([image, up]), conv)
                loss = rdf.cosine_loss(feats[1], feats[0])
                (dpose,) = torch.autograd.grad(loss, at)
                grads = torch.autograd.grad(pose_f, leaves_f, grad_outputs=dpose,
                                            allow_unused=True)
                grads = [torch.zeros_like(t) if g is None else g
                         for t, g in zip(leaves_f, grads)]
                out["losses"].append(float(loss.detach()))
                out["poses"].append(pose_f.detach().cpu())
                out["raw"].append(raw_f.detach().cpu())
                out["dpose"].append(dpose.cpu())
                if k == 0:
                    out["grad1"] = {p: g.detach().cpu() for p, g in zip(paths, grads)}
                with torch.no_grad():
                    ref.adam(leaves_f, grads, state, c["stage3"]["learning_rate"])
        out["params3"] = {p: t.detach().cpu() for p, t in zip(paths, leaves_f)}
        out["params0"] = {p: t.cpu() for p, t in leaves(self.dfnet)}
        return out

    def check(self) -> Dict[str, Dict[str, float]]:
        want = self.reference_steps(render_poses=self.out["poses"])
        return compare(self.out, want, self.wl["check"]["limits"])

    def control_readings(self, what: str) -> Dict[str, float]:
        """The check's numbers with the reference in the program's place:
        DFNet's convs at fp8 and the render's matmuls at TF32
        (what="fp8"), or the render's answer altered. The checked steps
        are the first of epoch 0 in the trainer's order (NumPy's
        permutation of its seeded generator)."""
        order = np.random.default_rng(self.rng_seed).permutation(len(self.poses))
        self.checked = [(int(i), None) for i in order[:self.wl["check_steps"]]]
        if what == "fp8":
            got = self.reference_steps(precision=("fp8", "tf32"))
        else:
            got = self.reference_steps(fault=what)
        want = self.reference_steps(render_poses=got["poses"])
        return {k: v["value"] for k, v in compare(got, want, self.wl["check"]["limits"]).items()}


def compare(got: Dict, want: Dict, limits: Dict[str, float]):
    """pose_gap: the first step's |gap of F's raw pose| (before the SVD
    projection) over |the reference's|: the later steps' poses carry the
    first update, which the SVD's backward amplifies where an untrained
    F's rotation block is near singular. loss_gap: the worst step's |loss
    gap| over the reference's loss. dpose_abs_gap: the worst step's
    |dL/dpose gap| at the same render pose, absolute: G's bf16 rounding
    gives a gap of steady size, and the reference's |dL/dpose| falls near
    it on some poses. grad_norm_gap, change_norm_gap: as the stage-1 train
    cell's, over F's leaves (each side's change from its own start: the
    program holds its convs in another layout)."""
    pose_gap = float((got["raw"][0] - want["raw"][0]).norm() / want["raw"][0].norm())
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    dpose_gap = max(float((a - b).norm()) if a is not None else math.inf
                    for a, b in zip(got["dpose"], want["dpose"]))
    gn_r = {k: float(v.norm()) for k, v in want["grad1"].items()}
    med_g = statistics.median(gn_r.values())
    grad_gap = max(abs(float(got["grad1"][k].norm()) - gn_r[k]) / max(gn_r[k], med_g)
                   for k in gn_r)
    kept = [k for k in gn_r if gn_r[k] >= NOUGHT_GRAD * med_g]
    ch_r = {k: float((want["params3"][k] - want["params0"][k]).norm()) for k in kept}
    med_c = statistics.median(ch_r.values())
    change_gap = max(abs(float((got["params3"][k] - got["params0"][k]).norm()) - ch_r[k])
                     / max(ch_r[k], med_c) for k in kept)
    vals = {"pose_gap": pose_gap, "loss_gap": loss_gap, "dpose_abs_gap": dpose_gap,
            "grad_norm_gap": grad_gap, "change_norm_gap": change_gap}
    return {k: {"value": v if v == v else float("inf"), "limit": limits[k]}
            for k, v in vals.items()}
