"""Stage-1 training steps, driven as NeRFTrainer.train_epoch drives them:
one train frame a step in the epoch's shuffled order, at the epoch's
decayed learning rate, and a sync only where an epoch ends (the loss the
epoch returns). No checkpoint and no eval.

Set-up makes a synthetic scene from the seed (the analytic field's frames
with their appearance jitter and histograms), hands the trainer the seeded
init this benchmark makes, and runs the first `check_steps` steps through
the window's own call: their losses, the first step's gradient (from the
Adam state it leaves) and the parameters after them are what the check
holds against the reference, which replays those steps from the same
init, frames and random draws (the trainer's generator is seeded with the
run's `--rng_seed`, and the reference draws the same pixel choice,
jitter and importance samples from a generator of that seed, in the
trainer's order).

The workload file gives: H, W, focal; frames; appearance_jitter;
check_steps; warmup_steps (more steps after them, before the window);
launches_per_step (the contract, checked on the checked steps); check
(limits).
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import numpy as np

from benchmark.generators.common import (Marks, check_launches, kernel_entry, program_flags,
                                      scene_data)
from benchmark.frozen import PEAK_F32, Sweep, point_flops, work
from benchmark.scene import (FAR, NEAR, frames_and_hists, init_nerfh, leaves, make_blob_field,
                             pixel_rays, sphere_poses, tree_map, tree_of)

ADAM_B1 = 0.9
# a leaf whose reference gradient is under this share of the median
# leaf's moves under Adam by round-off alone: left out of the change
NOUGHT_GRAD = 1e-3


class Cell:
    unit = "step"

    def __init__(self, cfg: Dict, wl: Dict, seed: int, device: str):
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.trace = None
        self.failed = 0

    # ------------------------------------------------------------ set-up
    def make_inputs(self) -> None:
        """The frames, poses, histograms, init and the trainer's seed."""
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
        self.init = init_nerfh(c, gen, self.device)

    def setup(self) -> None:
        from dfnet_tpu_torch.config import parse_args
        from dfnet_tpu_torch.data.loader import epoch_permutation
        from dfnet_tpu_torch.ops import nerf_kernels as nk
        from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer, exp_decayed_lr

        c, w = self.cfg, self.wl
        self.marks = mark = Marks()
        self.make_inputs()
        mark("inputs")
        scene = scene_data(self.frames, self.poses, self.hists, w["H"], w["W"], w["focal"],
                           NEAR, FAR)
        argv = program_flags(c) + ["--rng_seed", str(self.rng_seed), "--device", self.device]
        self.pcfg = parse_args(argv, stage="nerf")
        self.tr = NeRFTrainer(self.pcfg, scene, device=self.device)
        self.tr.load_params_tree(tree_map(lambda t: t.cpu().numpy(), self.init))
        if not self.tr.uses_fused_train:
            raise SystemExit("the trainer's step is not the kernel step")
        mark("trainer")
        self._permutation, self._lr = epoch_permutation, exp_decayed_lr
        self.order: List[int] = []
        self.new_epoch()

        before = dict(nk.LAUNCHES)
        self.checked = []
        for k in range(w["check_steps"]):
            self.checked.append(self.step())
            if k == 0:
                self.grad1 = self.first_gradient()
        self.params3 = {p: t.detach().clone() for p, t in self.named()}
        if self.device != "cpu":       # the wrappers count CUDA launches only
            check_launches(before, nk.LAUNCHES, w["launches_per_step"], w["check_steps"],
                           "the checked steps")
        for _ in range(w["warmup_steps"]):
            self.step()
        mark("checked and warm-up steps")
        self._work()

    def named(self):
        from dfnet_tpu_torch.training.nerf_trainer import named_leaves

        return named_leaves(self.tr.params)

    def first_gradient(self) -> Dict:
        """The gradient the optimizer got at the first step, from its state
        after it: Adam's first moment is then (1 - b1) g."""
        import torch

        st = self.tr.optimizer.state
        # a leaf the optimizer holds no moment of got no gradient
        return {p: st[t]["exp_avg"].detach() / (1.0 - ADAM_B1) if "exp_avg" in st.get(t, {})
                else torch.zeros_like(t) for p, t in self.named()}

    def new_epoch(self) -> None:
        if getattr(self, "last_loss", None) is not None:
            float(self.last_loss)              # the epoch's end: train_epoch reads its loss
            self.tr.global_step += 1
        self.epoch = self.tr.global_step
        self.lr = self._lr(self.pcfg, self.tr.global_step)
        self.order = [int(i) for i in self._permutation(len(self.poses), self.tr.order_rng)]

    def step(self):
        """One step through the trainer's train_step; (frame, lr, loss)."""
        if not self.order:
            self.new_epoch()
        idx = self.order.pop(0)
        loss, _ = self.tr.train_step(idx, self.lr, self.epoch)
        self.last_loss = loss
        return idx, self.lr, loss

    def _work(self) -> None:
        c, N = self.cfg, self.cfg["N_rand"]
        S, Sf = c["N_samples"], c["N_samples"] + c["N_importance"]
        skip = c["skips"][0]
        static = Sweep("static", N, S, c["netdepth"], c["netwidth"], skip, c["multires"])
        fine = Sweep("fine", N, Sf, c["netdepth_fine"], c["netwidth_fine"], skip, c["multires"])
        self.kernels = {"fine_raw_t": kernel_entry("fine_raw_t", 2, [static, fine]),
                        "raw_bwd_t": kernel_entry("raw_bwd_t", 2, [static, fine])}
        ops = [t for k in ("fine_raw_t", "raw_bwd_t") for s in (static, fine)
               for t in work(k, s)[0]]
        in_p = 3 + 6 * c["proposal_multires"]
        prop = N * S * point_flops(c["proposal_D"], c["proposal_W"], -1, in_p, kind="sigma")
        # the proposal net's float32 forward, and its backward: weight and
        # input gradients, none into the positional encoding
        ops.append((3 * prop - 2 * N * S * in_p * c["proposal_W"], PEAK_F32))
        self.ops_per_unit = ops

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> None:
        import torch

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

    def end_to_end(self) -> Dict[str, float]:
        return {"train_rays_per_s": self.units * self.cfg["N_rand"] / self.window_s}

    def release(self) -> None:
        import torch

        self.losses = [float(l) for _, _, l in self.checked]
        self.grad1 = {p: g.cpu() for p, g in self.grad1.items()}
        self.params3 = {p: t.cpu() for p, t in self.params3.items()}
        del self.tr
        if self.device != "cpu":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def reference_steps(self, precision: str = "fp32", fault: str = ""):
        """The reference's (losses, first gradient, parameters after the
        checked steps) from the same init, frames and draws. `fault`
        plants one of the faults the check must catch: "half_batch" (the
        loss over the first half of the rays), "answer_altered" (the fine
        net's static sigma out by one)."""
        import torch

        from benchmark import reference_nerfh as ref

        c, w, dev = self.cfg, self.wl, self.device
        H, W, f = w["H"], w["W"], w["focal"]
        sizes = dict(c, near=NEAR, far=FAR)
        paths = [p for p, _ in leaves(self.init)]
        params = [t.detach().clone().requires_grad_(True) for _, t in leaves(self.init)]
        tree = tree_of(zip(paths, params))
        gen = torch.Generator(device=dev).manual_seed(self.rng_seed)
        mm = ref.Matmul(precision)
        if fault == "answer_altered":
            fine_net = ref.fine_net

            def altered(*a, **k):
                out = fine_net(*a, **k)
                return (out[0], out[1] + 1.0) + tuple(out[2:])
            ref.fine_net = altered
        state, losses, grad1 = {}, [], {}
        try:
            with ref.float32_matmuls():
                for k, (idx, lr, _) in enumerate(self.checked):
                    ro, rd = pixel_rays(H, W, f, torch.as_tensor(self.poses[idx], device=dev))
                    sel = torch.randperm(H * W, generator=gen, device=dev)[:c["N_rand"]]
                    u_s = torch.rand((c["N_rand"], c["N_samples"]), generator=gen, device=dev)
                    u_i = torch.rand((c["N_rand"], c["N_importance"]), generator=gen, device=dev)
                    target = torch.as_tensor(self.frames[idx], device=dev).reshape(-1, 3)[sel]
                    hist = torch.as_tensor(self.hists[idx], device=dev)
                    args = [ro[sel], rd[sel], target, hist, u_s, u_i]
                    if fault == "half_batch":
                        args = [a if a is hist else a[:c["N_rand"] // 2] for a in args]
                    loss = ref.train_loss(tree, sizes, *args[:4], args[4], args[5], mm)
                    grads = torch.autograd.grad(loss, params, allow_unused=True)
                    grads = [torch.zeros_like(p) if g is None else g
                             for p, g in zip(params, grads)]
                    losses.append(float(loss.detach()))
                    if k == 0:
                        grad1 = {p: g.detach().cpu() for p, g in zip(paths, grads)}
                    with torch.no_grad():
                        ref.adam(params, grads, state, lr)
        finally:
            if fault == "answer_altered":
                ref.fine_net = fine_net
        return losses, grad1, {p: t.detach().cpu() for p, t in zip(paths, params)}

    def check(self) -> Dict[str, Dict[str, float]]:
        got = (self.losses, self.grad1, self.params3)
        init = {p: t.cpu() for p, t in leaves(self.init)}
        return compare(got, self.reference_steps(), init, self.wl["check"]["limits"])

    def control_readings(self, what: str) -> Dict[str, float]:
        """The check's numbers with the reference in the program's place:
        at fp8 operands (what="fp8"), or with a planted fault. The checked
        steps are the first of epoch 0, in the order the trainer's seeded
        generator gives (NumPy's permutation), at the initial rate."""
        order = np.random.default_rng(self.rng_seed).permutation(len(self.poses))
        self.checked = [(int(i), self.cfg["lrate"], None)
                        for i in order[:self.wl["check_steps"]]]
        want = self.reference_steps()
        got = self.reference_steps("fp8") if what == "fp8" else self.reference_steps(fault=what)
        init = {p: t.cpu() for p, t in leaves(self.init)}
        vals = compare(got, want, init, self.wl["check"]["limits"])
        return {k: v["value"] for k, v in vals.items()}


def compare(got, want, init: Dict, limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """loss_gap: the checked steps' worst |loss gap| over the reference's
    loss. grad_norm_gap: the worst leaf's gap between the first gradient's
    norms, over the reference's norm of that leaf or of the median leaf,
    whichever is larger. change_norm_gap: the same of the parameters'
    change over the checked steps, on the leaves whose reference gradient
    is not nought (NOUGHT_GRAD)."""
    (l_p, g_p, p_p), (l_r, g_r, p_r) = got, want
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(l_p, l_r))
    gn_r = {k: float(v.norm()) for k, v in g_r.items()}
    med_g = statistics.median(gn_r.values())
    grad_gap = max(abs(float(g_p[k].norm()) - gn_r[k]) / max(gn_r[k], med_g) for k in gn_r)
    kept = [k for k in gn_r if gn_r[k] >= NOUGHT_GRAD * med_g]
    ch_r = {k: float((p_r[k] - init[k]).norm()) for k in kept}
    med_c = statistics.median(ch_r.values())
    change_gap = max(abs(float((p_p[k] - init[k]).norm()) - ch_r[k]) / max(ch_r[k], med_c)
                     for k in kept)
    vals = {"loss_gap": loss_gap, "grad_norm_gap": grad_gap, "change_norm_gap": change_gap}
    return {k: {"value": v if v == v else float("inf"), "limit": limits[k]}
            for k, v in vals.items()}
