"""Rendered views served one at a time: a closed loop of one client asks
for a view, waits for its synchronised result, and asks for the next.

Each view goes through the render that NeRFTrainer.render_split calls
(`NeRFTrainer._render`, built by `_build_render`: render/fast.py's
render_image_fast with the weights packed on every call), on the trained
NeRF-H asset of the configuration, and is copied to the host as
render_split copies it. The views cycle through a pool of cameras drawn
from the seed on the sphere of the asset's synthetic cameras, with the
field of view of its val cameras; each view's histogram is that of the
analytic scene's frame at its pose.

The workload file gives: H, W, focal; pool_views; hist_size (the frame
the histogram is taken from); warmup_views; schedule (cull_q, n_fine,
n_place: 0 is the exact union at the configuration's samples);
launches_per_view (the launch contract, checked while warming up);
check (views: how many of the window's views the reference renders;
limits).
"""

from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np

from benchmark import harness
from benchmark.generators.common import (Marks, check_launches, kernel_entry, program_flags,
                                      scene_data)
from benchmark.frozen import PEAK_BF16, Sweep, point_flops
from benchmark.scene import (FAR, NEAR, frames_and_hists, load_npz_tree, make_blob_field,
                             pixel_rays, sphere_poses, tree_map)


# the numbers the check can compare; a cell's limits name those it does
NUMBERS = ("rgb_rmse", "rgb_mae", "acc_mae", "disp_rel")


def schedule_flags(s: Dict) -> list:
    """The stage-1 CLI flags of a render schedule."""
    if s.get("cull_q", 0.0) <= 0.0:
        return []
    return ["--render_cull_q", str(s["cull_q"]), "--render_fine_total", str(s["n_fine"]),
            "--render_place_samples", str(s["n_place"])]


class Cell:
    unit = "view"

    def __init__(self, cfg: Dict, wl: Dict, seed: int, device: str):
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.trace = None
        self.failed = 0

    # ------------------------------------------------------------ set-up
    def make_inputs(self) -> None:
        """The pool's poses and histograms, and the asset's params."""
        c, w = self.cfg, self.wl
        rng = np.random.default_rng(self.seed)
        self.poses = sphere_poses(w["pool_views"], rng)
        hh, hw = w["hist_size"]
        _, self.hists = frames_and_hists(make_blob_field(c["scene_seed"]), self.poses, hh, hw,
                                         w["focal"] * hw / w["W"], np.ones(len(self.poses)),
                                         self.device, c["hist_bin"])
        self.asset = load_npz_tree(str(harness.ROOT / c["asset"]))

    def setup(self) -> None:
        from dfnet_tpu_torch.config import parse_args
        from dfnet_tpu_torch.ops import nerf_kernels as nk
        from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer

        c, w = self.cfg, self.wl
        H, W, f = w["H"], w["W"], w["focal"]
        self.marks = mark = Marks()
        self.make_inputs()
        mark("inputs")
        blank = np.zeros((1, H, W, 3), np.float32)
        scene = scene_data(blank, self.poses[:1], self.hists[:1], H, W, f, NEAR, FAR)
        argv = program_flags(c) + schedule_flags(w["schedule"]) + ["--device", self.device]
        self.tr = NeRFTrainer(parse_args(argv, stage="nerf"), scene, device=self.device)
        self.tr.load_params_tree(self.asset)
        if not self.tr.uses_fast_render:
            raise SystemExit("the trainer's render does not take the kernel path")
        mark("trainer")
        before = dict(nk.LAUNCHES)
        for i in range(w["warmup_views"]):
            self.serve(i)
        if self.device != "cpu":       # the wrappers count CUDA launches only
            check_launches(before, nk.LAUNCHES, w["launches_per_view"], w["warmup_views"],
                           "warm-up")
        mark("warm-up")
        self._work()

    def _work(self) -> None:
        c, s = self.cfg, self.wl["schedule"]
        N = self.wl["H"] * self.wl["W"]
        P = s.get("n_place") or c["N_samples"]
        Sf = s.get("n_fine") or c["N_samples"] + c["N_importance"]
        place = Sweep("sigma", N, P, c["proposal_D"], c["proposal_W"], -1,
                      c["proposal_multires"])
        fine = Sweep("fine", N, Sf, c["netdepth_fine"], c["netwidth_fine"], c["skips"][0],
                     c["multires"])
        self.kernels = {"coarse_sigma_t": kernel_entry("coarse_sigma_t", 1, [place]),
                        "fine_raw_t": kernel_entry("fine_raw_t", 1, [fine])}
        in_p, in_x = 3 + 6 * c["proposal_multires"], 3 + 6 * c["multires"]
        self.ops_per_unit = [
            (N * P * point_flops(c["proposal_D"], c["proposal_W"], -1, in_p, kind="sigma"),
             PEAK_BF16),
            (N * Sf * point_flops(c["netdepth_fine"], c["netwidth_fine"], c["skips"][0], in_x),
             PEAK_BF16)]

    # ------------------------------------------------------------ window
    def serve(self, i: int):
        """One request: view i of the pool rendered, copied to the host."""
        import torch

        k = i % len(self.poses)
        pose = torch.as_tensor(self.poses[k], dtype=torch.float32, device=self.device)
        hist = torch.as_tensor(self.hists[k], device=self.device)
        out = self.tr._render(self.tr.params, pose, hist, self.tr.global_step)
        return tuple(out[key].cpu() for key in ("rgb", "disp", "acc"))

    def window(self, seconds: float) -> None:
        self.latency, self.outputs = [], []
        t0 = time.perf_counter()
        end = t0 + seconds
        now = t0
        while now < end:
            t = now
            self.outputs.append(self.serve(len(self.outputs)))
            now = time.perf_counter()
            self.latency.append(now - t)
        self.window_s = now - t0
        self.units = len(self.outputs)
        self.attempted = self.units

    def end_to_end(self) -> Dict[str, float]:
        rays = self.units * self.wl["H"] * self.wl["W"]
        return {"render_rays_per_s": rays / self.window_s,
                "render_view_ms_p95": harness.percentile(self.latency, 95) * 1e3}

    def release(self) -> None:
        import torch

        del self.tr
        if self.device != "cpu":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def reference_outputs(self, idx, precision: str = "fp32"):
        """The reference's (rgb, disp, acc) of the pool views `idx` at the
        given matmul precision, from the asset file."""
        import torch

        from benchmark import reference_nerfh as ref

        c, w = self.cfg, self.wl
        H, W, f = w["H"], w["W"], w["focal"]
        params = tree_map(lambda a: torch.as_tensor(a, device=self.device), self.asset)
        sizes = dict(c, near=NEAR, far=FAR)
        out = []
        with ref.float32_matmuls():
            for i in idx:
                k = i % len(self.poses)
                ro, rd = pixel_rays(H, W, f, torch.as_tensor(self.poses[k], device=self.device))
                hist = torch.as_tensor(self.hists[k], device=self.device)
                r = ref.render_view(params, sizes, w["schedule"], ro, rd, hist,
                                    ref.Matmul(precision))
                out.append((r["rgb"].cpu(), r["disp"].cpu(), r["acc"].cpu()))
        return out

    def sample(self):
        """The window's views the check renders: drawn from the seed, and
        the last one."""
        n, k = len(self.outputs), self.wl["check"]["views"]
        rng = np.random.default_rng([self.seed, 1])
        pick = rng.choice(n - 1, size=min(k - 1, n - 1), replace=False) if n > 1 else []
        return sorted(set(int(i) for i in pick) | {n - 1})

    def check(self) -> Dict[str, Dict[str, float]]:
        idx = self.sample()
        got = [self.outputs[i] for i in idx]
        return compare(got, self.reference_outputs(idx), self.wl["check"]["limits"])

    def control_readings(self, what: str) -> Dict[str, float]:
        """The check's numbers with the reference at fp8 operands in the
        program's place (what="fp8"), on the pool's first views."""
        if what != "fp8":
            raise ValueError(f"no fault {what!r} planted in the render reference")
        idx = list(range(self.wl["check"]["views"]))
        got = self.reference_outputs(idx, "fp8")
        vals = compare(got, self.reference_outputs(idx), dict.fromkeys(NUMBERS, math.inf))
        return {k: v["value"] for k, v in vals.items()}


def compare(got, want, limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """The worst view's numbers, those the cell's limits name: rgb RMSE,
    rgb mean |gap|, mean |acc gap|, and mean |disparity gap| over the mean
    disparity where the reference's acc is above 0.5."""
    import torch

    worst = dict.fromkeys(NUMBERS, 0.0)
    for (rgb, disp, acc), (r_rgb, r_disp, r_acc) in zip(got, want):
        rgb, disp, acc = rgb.reshape(-1, 3), disp.reshape(-1), acc.reshape(-1)
        m = r_acc > 0.5
        vals = {"rgb_rmse": float(torch.sqrt(torch.mean((rgb - r_rgb) ** 2))),
                "rgb_mae": float(torch.mean((rgb - r_rgb).abs())),
                "acc_mae": float(torch.mean((acc - r_acc).abs())),
                "disp_rel": float((disp[m] - r_disp[m]).abs().mean() / r_disp[m].mean())
                if bool(m.any()) else 0.0}
        for k, v in vals.items():
            worst[k] = max(worst[k], v) if v == v else float("inf")
    return {k: {"value": worst[k], "limit": v} for k, v in limits.items()}
