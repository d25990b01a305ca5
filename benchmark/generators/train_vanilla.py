"""Stage-1 training of the original NeRF (NeRFH=False), driven as
NeRFTrainer.train_epoch drives it: one train frame a step in the epoch's
shuffled order, N_rand rays of it, at the epoch's decayed learning rate,
and a sync only where an epoch ends. No checkpoint and no eval.

What it shares with `train` (benchmark/generators/train.py): the driving,
the checked steps and the parameters' change (`train.compare`'s
change_norm_gap). What differs: the inputs are the analytic scene's frames
over a white background (the Blender scenes' convention) at the cell's
size and focal, the init is the vanilla pair's (models/nerf_vanilla.py's
tree), the reference is benchmark/reference_nerf.py, the work is both
nets' static sweeps, and the check holds:
- change_norm_gap, as `train` computes it;
- rgb_median_gap: the worst checked step's median over its rays of the
  mean |gap| of the fine rgb the step rendered (kept while set-up runs the
  checked steps) to the reference's;
- plain_route_steps: the steps that did not take the kernel route, from
  training/nerf_trainer.py's ROUTES (limit 0).
The loss and first-gradient gaps are not held. The last interval of the
original NeRF's quadrature is 1e10 long, so a ray whose density there sits
within a bf16 rounding of nought turns opaque or clear by it: a few rays
of a batch move by up to the whole colour, which the loss and the
gradients carry in full and a median over rays does not. Their sound
readings' tails reach those of the fp8 control (PERF.md section 2).

The workload file gives what `train` reads, less appearance_jitter, and:
frame_samples (the quadrature of the frames), reference_block (rays a
block of the reference's loss).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from benchmark.frozen import Sweep, work
from benchmark.generators import train
from benchmark.generators.common import kernel_entry
from benchmark.scene import (FAR, NEAR, _put, leaves, make_blob_field, pixel_rays,
                             sphere_poses, tree_of)

HIST_BINS = 10     # the scene container's histograms, which the vanilla net never reads
# A net whose ReLU density is nought at every point of the scene gets no
# gradient at all (the original NeRF's known stall at init, which its users
# meet by starting again): the init is the seed generator's first draw on
# which each net's density is positive at ALIVE of the points it is probed
# at, within ALIVE_DRAWS draws (about half the draws at W=256 pass).
ALIVE = 0.05
ALIVE_DRAWS = 32


def white_frames(field, poses: np.ndarray, H: int, W: int, focal: float, device,
                 n_samples: int, block: int = 1 << 17) -> np.ndarray:
    """(B, H, W, 3) float32 frames of the field at `poses` (B, 3, 4) over a
    white background: float32 quadrature at n_samples evenly spaced depths
    in [NEAR, FAR], the colour as scene.render_frames weighs it."""
    import torch

    dev = torch.device(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    centers, sigmas, amps, colors = (f32(field.centers), f32(field.sigmas), f32(field.amps),
                                     f32(field.colors))
    t = torch.linspace(NEAR, FAR, n_samples, device=dev)
    delta = (FAR - NEAR) / (n_samples - 1)
    c2 = (centers ** 2).sum(-1)
    out = torch.empty((len(poses), H * W, 3), device=dev)
    for b, pose in enumerate(torch.as_tensor(poses, device=dev)):
        ro, rd = pixel_rays(H, W, focal, pose)
        for lo in range(0, H * W, block):
            pts = ro[lo:lo + block, None] + rd[lo:lo + block, None] * t[:, None]
            d2 = (pts ** 2).sum(-1, keepdim=True) - 2.0 * pts @ centers.T + c2
            g = amps * torch.exp(-0.5 * d2.clamp(min=0.0) / sigmas ** 2)     # (n, S, K)
            rgb = torch.clamp(g @ colors / (g.sum(-1, keepdim=True) + 1e-8), 0.0, 1.0)
            alpha = 1.0 - torch.exp(-g.sum(-1) * delta)
            trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
            trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
            wts = alpha * trans
            out[b, lo:lo + block] = ((wts[..., None] * rgb).sum(-2)
                                     + (1.0 - wts.sum(-1, keepdim=True)))
    return torch.clamp(out, 0.0, 1.0).reshape(len(poses), H, W, 3).cpu().numpy()


def vanilla_layers(c: Dict):
    """[(path, fan_in, fan_out)] of every linear layer of the vanilla pair
    that the configuration `c` describes (models/nerf_vanilla.py's names)."""
    in_xyz, in_dir = 3 + 6 * c["multires"], 3 + 6 * c["multires_views"]
    out = []
    for net, D, W in (("coarse", c["netdepth"], c["netwidth"]),
                      ("fine", c["netdepth_fine"], c["netwidth_fine"])):
        out += [(f"{net}/pts_{i}", in_xyz if i == 0 else
                 (W + in_xyz if i - 1 in c["skips"] else W), W) for i in range(D)]
        out += [(f"{net}/feature", W, W), (f"{net}/alpha", W, 1),
                (f"{net}/views_0", W + in_dir, W // 2), (f"{net}/rgb", W // 2, 3)]
    return out


def init_vanilla(c: Dict, gen, device) -> Dict:
    """A seeded vanilla params tree on `device` at the port's init law
    (torch.nn.Linear's uniform bound), in one draw."""
    import torch

    layers = vanilla_layers(c)
    u = torch.rand(sum(fi * fo + fo for _, fi, fo in layers), generator=gen,
                   device=device) * 2 - 1
    tree: Dict = {}
    off = 0
    for path, fi, fo in layers:
        bound = 1.0 / math.sqrt(fi)
        _put(tree, path + "/w", u[off:off + fi * fo].view(fi, fo) * bound)
        off += fi * fo
        _put(tree, path + "/b", u[off:off + fo] * bound)
        off += fo
    return tree


def density_share(tree: Dict, c: Dict, rays_o, rays_d) -> float:
    """The smaller of the two nets' shares of the points at the
    configuration's N_samples evenly spaced depths along the rays where the
    reference's density is positive."""
    import torch

    from benchmark import reference_nerf as ref
    from benchmark.reference_nerfh import Matmul, embed

    z = ref.stratified(rays_o.shape[0], c["N_samples"], NEAR, FAR, rays_o.device)
    x0 = embed(rays_o[:, None] + rays_d[:, None] * z[..., None], c["multires"])
    d = embed(rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True), c["multires_views"])
    with torch.no_grad():
        return min(float((ref.nerf(tree[net], x0, d, D, c["skips"], Matmul())[1] > 0)
                         .float().mean())
                   for net, D in (("coarse", c["netdepth"]), ("fine", c["netdepth_fine"])))


class Cell(train.Cell):

    def make_inputs(self) -> None:
        """The frames, poses, init and the trainer's seed."""
        import torch

        c, w = self.cfg, self.wl
        H, W, f, n = w["H"], w["W"], w["focal"], w["frames"]
        rng = np.random.default_rng(self.seed)
        field_seed, self.rng_seed, init_seed = (int(x) for x in rng.integers(0, 2**31 - 1, 3))
        self.poses = sphere_poses(n, rng)
        self.frames = white_frames(make_blob_field(field_seed), self.poses, H, W, f,
                                   self.device, w["frame_samples"])
        self.hists = np.zeros((n, HIST_BINS), np.int32)
        gen = torch.Generator(device=self.device).manual_seed(init_seed)
        ro, rd = pixel_rays(H, W, f, torch.as_tensor(self.poses[0], device=self.device))
        probe = slice(None, None, max(1, H * W // 1024))
        for _ in range(ALIVE_DRAWS):
            self.init = init_vanilla(c, gen, self.device)
            if density_share(self.init, c, ro[probe], rd[probe]) >= ALIVE:
                break

    def setup(self) -> None:
        from dfnet_tpu_torch.training import nerf_trainer

        self.routes = getattr(nerf_trainer, "ROUTES", {})
        self.routes0 = dict(self.routes)
        self.steps_run = 0
        # the fine rgb of set-up's steps, from the render the step calls
        self.rendered = []
        render = nerf_trainer.render_rays_train_fused

        def kept(*a, **k):
            out = render(*a, **k)
            self.rendered.append(out["rgb"].detach().clone())
            return out
        nerf_trainer.render_rays_train_fused = kept
        try:
            super().setup()
        finally:
            nerf_trainer.render_rays_train_fused = render

    def step(self):
        self.steps_run += 1
        return super().step()

    def _work(self) -> None:
        c, N = self.cfg, self.cfg["N_rand"]
        skip = c["skips"][0] + 1              # the layer that reads [x0 | h]
        coarse = Sweep("static", N, c["N_samples"], c["netdepth"], c["netwidth"], skip,
                       c["multires"])
        fine = Sweep("static", N, c["N_samples"] + c["N_importance"], c["netdepth_fine"],
                     c["netwidth_fine"], skip, c["multires"])
        self.kernels = {"fine_raw_t": kernel_entry("fine_raw_t", 2, [coarse, fine]),
                        "raw_bwd_t": kernel_entry("raw_bwd_t", 2, [coarse, fine])}
        self.ops_per_unit = [t for k in ("fine_raw_t", "raw_bwd_t") for s in (coarse, fine)
                             for t in work(k, s)[0]]

    def reference_steps(self, precision: str = "fp32", fault: str = ""):
        """The reference's (losses, first gradient, parameters after the
        checked steps) from the same init, frames and draws. `fault`
        plants one of the faults the check must catch: "half_batch" (the
        loss over the first half of the rays), "answer_altered" (the fine
        net's raw rgb out by one)."""
        import torch

        from benchmark import reference_nerf as ref
        from benchmark.reference_nerfh import Matmul, adam

        c, w, dev = self.cfg, self.wl, self.device
        H, W, f, n, S, I = (w["H"], w["W"], w["focal"], c["N_rand"], c["N_samples"],
                            c["N_importance"])
        sizes = dict(c, near=NEAR, far=FAR)
        paths = [p for p, _ in leaves(self.init)]
        params = [t.detach().clone().requires_grad_(True) for _, t in leaves(self.init)]
        tree = tree_of(zip(paths, params))
        gen = torch.Generator(device=dev).manual_seed(self.rng_seed)
        mm = Matmul(precision)
        nerf = ref.nerf
        if fault == "answer_altered":
            def altered(p, *a, **k):
                rgb, sigma = nerf(p, *a, **k)
                return rgb + 1.0 if p is tree["fine"] else rgb, sigma
            ref.nerf = altered
        state, losses, grad1, rgbs = {}, [], {}, []
        try:
            for k, (idx, lr, _) in enumerate(self.checked):
                ro, rd = pixel_rays(H, W, f, torch.as_tensor(self.poses[idx], device=dev))
                sel = torch.randperm(H * W, generator=gen, device=dev)[:n]
                u_s = torch.rand((n, S), generator=gen, device=dev)
                u_i = torch.rand((n, I), generator=gen, device=dev)
                target = torch.as_tensor(self.frames[idx], device=dev).reshape(-1, 3)[sel]
                args = [ro[sel], rd[sel], target, u_s, u_i]
                if fault == "half_batch":
                    args = [a[:n // 2] for a in args]
                loss, grads, rgb = ref.loss_and_grads(params, tree, sizes, *args, mm,
                                                      w["reference_block"])
                losses.append(loss)
                rgbs.append(rgb.cpu())
                if k == 0:
                    grad1 = {p: g.detach().cpu() for p, g in zip(paths, grads)}
                with torch.no_grad():
                    adam(params, grads, state, lr)
        finally:
            ref.nerf = nerf
        return (losses, grad1, {p: t.detach().cpu() for p, t in zip(paths, params)}, rgbs)

    def release(self) -> None:
        self.rendered = [r.cpu() for r in self.rendered[:self.wl["check_steps"]]]
        super().release()

    def check(self) -> Dict[str, Dict[str, float]]:
        limits = self.wl["check"]["limits"]
        init = {p: t.cpu() for p, t in leaves(self.init)}
        got = (self.losses, self.grad1, self.params3, self.rendered)
        out = compare(got, self.reference_steps(), init, limits)
        kernel = self.routes.get("kernel_steps", 0) - self.routes0.get("kernel_steps", 0)
        out["plain_route_steps"] = {"value": float(self.steps_run - kernel),
                                    "limit": limits["plain_route_steps"]}
        return out

    def control_readings(self, what: str) -> Dict[str, float]:
        """The check's numbers with the reference in the program's place:
        at fp8 operands (what="fp8"), or with a planted fault, on the first
        checked steps of epoch 0 (train.Cell.control_readings)."""
        order = np.random.default_rng(self.rng_seed).permutation(len(self.poses))
        self.checked = [(int(i), self.cfg["lrate"], None)
                        for i in order[:self.wl["check_steps"]]]
        want = self.reference_steps()
        got = self.reference_steps("fp8") if what == "fp8" else self.reference_steps(fault=what)
        init = {p: t.cpu() for p, t in leaves(self.init)}
        vals = compare(got, want, init, self.wl["check"]["limits"])
        return {k: v["value"] for k, v in vals.items()}


def rgb_median_gap(got, want) -> float:
    """The worst step's median over rays of the mean |rgb gap| over the
    channels; inf where a step's rays are missing or differ in number."""
    if len(got) != len(want):
        return float("inf")
    worst = 0.0
    for g, r in zip(got, want):
        if g.shape != r.shape:
            return float("inf")
        worst = max(worst, float((g - r).abs().mean(-1).median()))
    return worst


def compare(got, want, init: Dict, limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """train.compare's change_norm_gap of (losses, first gradient,
    parameters after the checked steps), and rgb_median_gap of the steps'
    fine rgb."""
    change = train.compare(got[:3], want[:3], init, dict.fromkeys(
        ("loss_gap", "grad_norm_gap", "change_norm_gap"), 0.0))["change_norm_gap"]["value"]
    v = rgb_median_gap(got[3], want[3])
    return {"change_norm_gap": {"value": change, "limit": limits["change_norm_gap"]},
            "rgb_median_gap": {"value": v if v == v else float("inf"),
                               "limit": limits["rgb_median_gap"]}}
