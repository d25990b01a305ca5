"""Stage 1 — NeRF-H training and evaluation (port of
dfnet_tpu/training/nerf_trainer.py).

Per epoch, for every train image in a shuffled order: sample N_rand
random pixels, render them through coarse + fine (the kernel path
render/fused_train.py, or the plain render/volume.py), NeRF-W loss plus
the proposal sampler's bound loss, backward, and an Adam update at
lr = lrate * 0.1^(global_step / (lrate_decay * 1000)), where global_step
advances once per epoch (the reference's schedule). Under the culled
schedule (--train_cull_q) with --train_cull_warmup E, epochs below E train
at the reference schedule's sampling first (`NeRFTrainer.schedule`), each
schedule on the kernel step where it can serve. Splits render at test
settings through render/fast.py or the plain renderer. A vanilla NeRF
(NeRFH=False) takes the same two routes, each where the one gate
(`render/fast.py::kernels_serve`) admits it; `ROUTES` counts the
steps and views each route served. Checkpoints hold the params and the
Adam state in the JAX package's layout.

Under a torch.profiler trace (utils/profiling.py::annotate) a step is the
region `dfnet.train.step`, holding `dfnet.train.draw`, the kernel render's
phases (render/fused_train.py), `dfnet.train.proposal`,
`dfnet.train.backward` and `dfnet.train.adam`.

Random draws come from explicit generators: `gen` (on the device) for the
pixel selection and the render's samples, a numpy generator for the
epoch order; the params are initialised from a CPU generator.

With a mesh (parallel/mesh.py; the JAX package's ray-data-parallel step)
every rank draws the step's pixel selection and every random tensor of
its render at the batch's shape from the same generator (RowShard) and
keeps its rows, so world n draws what world 1 draws at any perturb. Each
rank's loss is a mean over its rays, weighted by its share of N_rand, and
the weighted grads are summed over ranks: every stage-1 loss term is a
mean over rays, so that is the one-device gradient for any split. The
kernels run per rank on its rays. Eval renders split the ray axis
(render_image_fast or render_image with mesh=); rank 0 writes the
checkpoints and images.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from dfnet_tpu_torch.config import Config, check_finite_loss
from dfnet_tpu_torch.data.loader import epoch_permutation
from dfnet_tpu_torch.data.png import write_apng, write_png
from dfnet_tpu_torch.data.scene import SceneData
from dfnet_tpu_torch.device import resolve_device
from dfnet_tpu_torch.models.factory import create_nerfh, render_settings
from dfnet_tpu_torch.models.losses import (
    img2mse,
    mse2psnr,
    nerfw_loss,
    proposal_bound_loss,
    to8b,
)
from dfnet_tpu_torch.models.nerfw import nerfw_apply_rays
from dfnet_tpu_torch.parallel.mesh import all_reduce_grads_, is_main, shard_rows
from dfnet_tpu_torch.render import fast as fast_mod
from dfnet_tpu_torch.render.fused_train import render_rays_train_fused
from dfnet_tpu_torch.render.rays import get_rays
from dfnet_tpu_torch.render.sampling import RowShard
from dfnet_tpu_torch.render.volume import (
    NeRFHModel,
    RenderSettings,
    VanillaNeRFModel,
    composite_nerfw,
    render_rays,
    render_rays_vanilla,
)
from dfnet_tpu_torch.training.checkpoints import (
    ADAM_HYPER,
    adam_state_from_tree,
    adam_state_tree,
    latest_checkpoint,
    load_pytree,
    params_from_numpy,
    save_pytree,
)
from dfnet_tpu_torch.utils.profiling import annotate


# stage-1 steps (stage1_loss) and the trainer's rendered views by route:
# the kernels or the plain renderer (reset_routes() zeroes)
ROUTES = {"kernel_steps": 0, "plain_steps": 0, "kernel_views": 0, "plain_views": 0}


def reset_routes() -> None:
    for k in ROUTES:
        ROUTES[k] = 0


def exp_decayed_lr(cfg: Config, global_step: int) -> float:
    return cfg.lrate * (0.1 ** (global_step / (cfg.lrate_decay * 1000.0)))


def write_video(base: str, frames: np.ndarray, fps: int = 15) -> str:
    """Write an image sequence as an animated PNG at <base>.png, 15 frames a
    second by default, and return its path. frames: (N, H, W[, 3]) floats
    in [0, 1], stored as to8b of each. The JAX package writes the same
    to8b frames as mp4 through imageio (gif where ffmpeg is missing), both
    lossy encodings; the GPU machine has neither imageio nor ffmpeg, and an
    APNG holds the frames exactly, so the container is the only difference."""
    path = base + ".png"
    write_apng(path, to8b(frames), fps)
    return path


def named_leaves(tree: Dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf of a params tree, in sorted key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += named_leaves(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def tree_map(fn: Callable, tree: Dict) -> Dict:
    """fn applied to every leaf of a nested dict of tensors."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def stage1_loss(params: Dict, model: Union[NeRFHModel, VanillaNeRFModel], cfg: Config,
                settings: RenderSettings, rays_o, rays_d, target, hist,
                gen: Optional[torch.Generator], fused: bool,
                epoch: Optional[float] = None):
    """(loss, fine-rgb MSE) of one ray batch: the NeRF-W loss of the
    kernel (`fused`) or plain render (for a vanilla model
    render_rays_train_vanilla or render_rays_vanilla: no beta, so c_l +
    f_l), plus the proposal sampler's bound loss against the fine weights
    (which carry no gradient, so only the proposal learns from it).
    `epoch` sets the frequency window of the plain render's embedders
    under --reduce_embedding 2 and is dropped otherwise, as in the
    reference; the kernel render never windows (fast.kernels_serve
    refuses a windowed embedder)."""
    ep = epoch if cfg.reduce_embedding == 2 else None
    ROUTES["kernel_steps" if fused else "plain_steps"] += 1
    if fused:
        out = render_rays_train_fused(params, model, rays_o, rays_d, hist, settings, gen)
    elif isinstance(model, VanillaNeRFModel):
        out = render_rays_vanilla(params, model, rays_o, rays_d, settings, gen, epoch=ep)
    else:
        out = render_rays(params, model, rays_o, rays_d, hist, settings, gen, epoch=ep)
    loss = sum(nerfw_loss(out, target).values())
    if model.cfg_proposal is not None and "proposal" in params and "weights_fine" in out:
        with annotate("dfnet.train.proposal"):
            z_vals = out["z_vals"].detach()
            pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
            sig_p = nerfw_apply_rays(params["proposal"], model.cfg_proposal,
                                     model.embed_proposal(pts), sigma_only=True)
            comp_p = composite_nerfw(sig_p, z_vals, output_transient=False,
                                     sigma_only=True)
            loss = loss + cfg.proposal_loss_w * proposal_bound_loss(
                comp_p["weights"], z_vals, out["weights_fine"], out["z_all"])
    return loss, img2mse(out["rgb"], target)


class NeRFTrainer:
    """Owns the model, params, optimizer, train step and render function."""

    def __init__(self, cfg: Config, scene: SceneData, device=None,
                 gen: Optional[torch.Generator] = None, mesh=None):
        self.cfg = cfg
        self.scene = scene
        self.mesh = mesh
        if device is None:
            device = mesh.device() if mesh is not None else cfg.device
        self.device = resolve_device(device)
        if gen is None:
            gen = torch.Generator().manual_seed(cfg.rng_seed)
        self.model, params = create_nerfh(cfg, gen, self.device)
        self.settings = render_settings(cfg, scene.near, scene.far)
        self.settings_test = render_settings(cfg, scene.near, scene.far, test=True)
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.rng_seed)
        self.order_rng = np.random.default_rng(cfg.rng_seed)
        self.global_step = 0
        self._set_params(params)
        # the whole train split lives on the device; steps index it there
        tr = scene.train
        self._images = torch.as_tensor(tr.images, dtype=torch.float32, device=self.device)
        self._poses = torch.as_tensor(tr.poses, dtype=torch.float32, device=self.device)
        self._hists = torch.as_tensor(tr.hists, device=self.device)
        # the culled schedule's warmup (JAX's _epoch_warm): epochs below
        # train_cull_warmup train at the reference schedule's settings
        self.settings_warm = None
        if cfg.train_cull_q > 0.0 and cfg.train_cull_warmup > 0:
            self.settings_warm = dataclasses.replace(self.settings, train_cull_q=0.0,
                                                     train_fine_total=0)
        # which step serves each schedule: the kernels, or the plain render
        self.uses_fused_train = self._fused_for(self.settings)
        self.uses_fused_train_warm = (self._fused_for(self.settings_warm)
                                      if self.settings_warm is not None else None)
        self._build_render()

    def _fused_for(self, settings: RenderSettings) -> bool:
        return bool(self.cfg.fused_train and self._kernels_serve(settings, train=True))

    def _kernels_serve(self, settings: RenderSettings, train: bool,
                       cull_q: float = 0.0) -> bool:
        """fast.kernels_serve, and not under --reduce_embedding 2: the JAX
        trainer's rule, kept although the gate refuses the windowed
        embedders that flag builds, because under --i_embed -1 it builds
        identity embedders, which are not windowed."""
        return (self.cfg.reduce_embedding != 2
                and fast_mod.kernels_serve(self.model, settings, train, cull_q))

    def schedule(self, epoch: float) -> Tuple[RenderSettings, bool]:
        """(train settings, kernel step?) in force at this epoch: the
        reference schedule (no culling) before train_cull_warmup when the
        culled schedule has a warmup, else the configured one. The rule
        reads the epoch only, so a resumed run and every rank of a mesh
        switch at the same epoch."""
        if self.settings_warm is not None and epoch < self.cfg.train_cull_warmup:
            return self.settings_warm, self.uses_fused_train_warm
        return self.settings, self.uses_fused_train

    def _set_params(self, params: Dict) -> None:
        """Adopt a params tree as trainable leaves with a fresh Adam."""
        self.params = tree_map(lambda t: t.detach().float().requires_grad_(True),
                               params)
        self._named = named_leaves(self.params)
        self.optimizer = torch.optim.Adam(
            [t for _, t in self._named], lr=self.cfg.lrate,
            betas=(ADAM_HYPER["b1"], ADAM_HYPER["b2"]), eps=ADAM_HYPER["eps"])

    # ------------------------------------------------------------- step
    def train_step(self, idx: int, lr: float, epoch: Optional[float] = None):
        """One update on N_rand random pixels of train image `idx` at the
        given epoch (default: global_step, which is the epoch the CLI
        trains); returns (loss, psnr) as device tensors."""
        with annotate("dfnet.train.step"):
            if epoch is None:
                epoch = self.global_step
            with annotate("dfnet.train.draw"):
                batch = self.draw_batch(idx)
            loss, mse = self.loss_and_grads(
                *batch, epoch, where=f"the stage-1 step of epoch {epoch} on train image {idx}")
            with annotate("dfnet.train.adam"):
                self.adam_update(lr)
            return loss, mse2psnr(mse)

    def draw_batch(self, idx: int):
        """(rays_o, rays_d, target, hist) of N_rand pixels of train image
        `idx` drawn without repeats from `gen`: the whole batch, on every
        rank of a mesh."""
        sc = self.scene
        rays_o, rays_d = get_rays(sc.H, sc.W, sc.focal, self._poses[idx])
        sel = torch.randperm(sc.H * sc.W, generator=self.gen,
                             device=self.device)[:self.cfg.N_rand]
        return (rays_o.reshape(-1, 3)[sel], rays_d.reshape(-1, 3)[sel],
                self._images[idx].reshape(-1, 3)[sel], self._hists[idx])

    def loss_and_grads(self, rays_o, rays_d, target, hist, epoch: float,
                       where: str = "a stage-1 step"):
        """(loss, fine-rgb MSE) of a ray batch with one histogram at the
        schedule in force at `epoch` (`schedule`), both detached, and the
        batch's grads in the leaves' .grad; under
        check_numerics a non-finite loss raises FloatingPointError naming
        `where` before the backward (on a mesh, this rank's). On a mesh,
        the loss and grads of the whole batch on every rank: this rank
        renders its rows (random draws at the batch's shape, RowShard), and
        its grads and values, weighted by its share of the rays, are summed
        over ranks in one all-reduce."""
        n, gen = rays_o.shape[0], self.gen
        if self.mesh is not None:
            lo, hi = shard_rows(n)
            rays_o, rays_d, target = rays_o[lo:hi], rays_d[lo:hi], target[lo:hi]
            gen = RowShard(self.gen, lo, hi, n)
        hist_b = hist[None].expand((rays_o.shape[0],) + hist.shape)
        settings, fused = self.schedule(epoch)
        loss, mse = stage1_loss(self.params, self.model, self.cfg, settings,
                                rays_o, rays_d, target, hist_b, gen, fused, epoch)
        if self.cfg.check_numerics:
            check_finite_loss(loss, where)
        with annotate("dfnet.train.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        loss, mse = loss.detach(), mse.detach()
        if self.mesh is not None:
            loss, mse = all_reduce_grads_([t for _, t in self._named],
                                          rays_o.shape[0] / n, torch.stack([loss, mse]))
        return loss, mse

    def adam_update(self, lr: float) -> None:
        """Adam (ADAM_HYPER, bias-corrected: optax's adam) on the leaves'
        .grad at learning rate lr. A leaf without a grad
        takes a zero one, so every moment decays each step as in optax."""
        for _, t in self._named:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()

    def train_epoch(self, epoch: int) -> Tuple[float, float]:
        """One pass over the shuffled train images at this epoch (at the
        schedule in force then, `schedule`); returns the last step's
        (loss, psnr), as the reference does."""
        if (self.settings_warm is not None and epoch == self.cfg.train_cull_warmup
                and is_main()):
            print("[nerf] warmup done, switching to culled train schedule", flush=True)
        lr = exp_decayed_lr(self.cfg, self.global_step)
        loss = psnr = torch.zeros(())
        for idx in epoch_permutation(len(self.scene.train), self.order_rng):
            loss, psnr = self.train_step(int(idx), lr, epoch)
        self.global_step += 1
        return float(loss), float(psnr)

    def _build_render(self):
        cfg, model = self.cfg, self.model
        H, W, focal = self.scene.H, self.scene.W, self.scene.focal
        rf = max(int(cfg.render_factor), 1) if cfg.render_factor else 1
        eh, ew, ef = H // rf, W // rf, focal / rf
        chunk = min(cfg.chunk, eh * ew)

        from dfnet_tpu_torch.render.volume import render_image

        mesh = self.mesh
        # under a mesh the kernels serve whenever they can, as in the JAX
        # package (its render_image_sharded takes no fast_render flag)
        cull = fast_mod.cull_schedule_kwargs(cfg)
        self.uses_fast_render = ((cfg.fast_render or mesh is not None)
                                 and self._kernels_serve(self.settings_test, train=False,
                                                         cull_q=cull["cull_q"]))
        if self.uses_fast_render:
            packs = fast_mod.PackCache()

            def render_one(params, pose, hist, epoch):
                ROUTES["kernel_views"] += 1
                return fast_mod.render_image_fast(
                    params, model, pose, hist, eh, ew, ef, self.settings_test,
                    chunk=chunk, use_proposal=cfg.proposal_render, **cull, packs=packs,
                    mesh=mesh)
        else:
            def render_one(params, pose, hist, epoch):
                ROUTES["plain_views"] += 1
                ep = epoch if cfg.reduce_embedding == 2 else None
                return render_image(params, model, pose, hist, eh, ew, ef,
                                    self.settings_test, chunk=chunk, epoch=ep,
                                    mesh=mesh)
        self._render = render_one
        self._render_factor = rf

    def render_split(self, split, savedir: Optional[str] = None,
                     max_images: Optional[int] = None, stride: int = 1,
                     video_base: Optional[str] = None) -> float:
        """Render a split at test settings at epoch global_step (the
        reference's eval epoch: the epochs trained, or the checkpoint's
        step under --render_test); returns the mean PSNR. On a mesh every
        rank renders its rays of each view and rank 0 writes. With savedir,
        writes <j>.png, <j>_GT.png and <j>_disp.png per view (disp over its
        own max). With video_base, also writes the videos <base>_rgb.png
        and <base>_disp.png (write_video; disp over the split's max), as
        --render_video_train / --render_video_test ask."""
        from dfnet_tpu_torch.data.color import downscale_area

        idxs = list(range(0, len(split), stride))
        if max_images:
            idxs = idxs[:max_images]
        psnrs, rgbs, disps = [], [], []
        for j, i in enumerate(idxs):
            pose = torch.as_tensor(split.poses[i], dtype=torch.float32,
                                   device=self.device)
            hist = torch.as_tensor(split.hists[i], device=self.device)
            out = self._render(self.params, pose, hist, self.global_step)
            rgb = out["rgb"].cpu().numpy()
            disp = out["disp"].cpu().numpy()
            gt = split.images[i]
            if self._render_factor != 1:
                gt = downscale_area(gt, float(self._render_factor))
            psnrs.append(-10.0 * np.log10(np.mean(np.square(rgb - gt))))
            if video_base:
                rgbs.append(rgb)
                disps.append(disp)
            if savedir and is_main():
                os.makedirs(savedir, exist_ok=True)
                write_png(osp.join(savedir, f"{j:03d}.png"), to8b(rgb))
                write_png(osp.join(savedir, f"{j:03d}_GT.png"), to8b(gt))
                write_png(osp.join(savedir, f"{j:03d}_disp.png"),
                          to8b(disp / max(disp.max(), 1e-8)))
        if video_base and rgbs and is_main():
            write_video(video_base + "_rgb", np.stack(rgbs))
            d = np.stack(disps)
            write_video(video_base + "_disp", d / max(d.max(), 1e-8))
        return float(np.mean(psnrs))

    # ------------------------------------------------------------- ckpt
    def expdir(self) -> str:
        return osp.join(self.cfg.basedir, self.cfg.expname)

    def opt_state_tree(self) -> tuple:
        """The Adam state in the JAX package's checkpoint layout."""
        count, mu, nu = 0, {}, {}
        for path, t in self._named:
            st = self.optimizer.state.get(t, {})
            if st:
                count = int(st["step"])
            mu[path] = st.get("exp_avg", torch.zeros_like(t))
            nu[path] = st.get("exp_avg_sq", torch.zeros_like(t))
        paths = {id(t): path for path, t in self._named}
        return adam_state_tree(
            count, self.optimizer.param_groups[0]["lr"],
            tree_map(lambda t: mu[paths[id(t)]], self.params),
            tree_map(lambda t: nu[paths[id(t)]], self.params))

    def _restore_opt_state(self, opt) -> bool:
        """Adopt a checkpoint's Adam state; False (optimizer stays cold)
        when its moments do not match the params leaf for leaf."""
        count, _, mu, nu = adam_state_from_tree(opt)
        mu_l, nu_l = named_leaves(mu), named_leaves(nu)
        want = [(p, tuple(t.shape)) for p, t in self._named]
        if [(p, np.shape(v)) for p, v in mu_l] != want or \
                [(p, np.shape(v)) for p, v in nu_l] != want:
            return False
        for (_, t), (_, m), (_, v) in zip(self._named, mu_l, nu_l):
            self.optimizer.state[t] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": torch.tensor(np.asarray(m, np.float32), device=self.device),
                "exp_avg_sq": torch.tensor(np.asarray(v, np.float32), device=self.device)}
        return True

    def save(self, epoch: int) -> str:
        path = osp.join(self.expdir(), f"{epoch:06d}.npz")
        save_pytree(path, {"params": self.params, "opt_state": self.opt_state_tree()},
                    global_step=self.global_step)
        return path

    def try_resume(self) -> int:
        """Load the newest checkpoint in the expdir (or cfg.ft_path), with
        its optimizer state when it has one."""
        path = self.cfg.ft_path
        if not path or path == "None":
            path = latest_checkpoint(self.expdir())
        if not path or self.cfg.no_reload or not osp.exists(path):
            return 0
        tree, scalars = load_pytree(path)
        loaded = params_from_numpy(tree["params"], self.device)
        for k in self.params:
            if k not in loaded:
                print(f"[nerf] checkpoint lacks '{k}' — keeping fresh init")
                loaded[k] = self.params[k]
        self._set_params(loaded)
        if "opt_state" in tree and not self._restore_opt_state(tree["opt_state"]):
            print("[nerf] checkpoint opt_state does not match the params — "
                  "optimizer restarts cold")
        self.global_step = int(scalars.get("global_step", 0))
        print(f"[nerf] resumed from {path} at step {self.global_step}")
        return self.global_step

    def load_params(self, path: str):
        tree, scalars = load_pytree(path)
        self.load_params_tree(tree["params"] if "params" in tree else tree)
        self.global_step = int(scalars.get("global_step", 0))

    def load_params_tree(self, tree: Dict) -> None:
        """Adopt a numpy params tree (a fresh optimizer with it)."""
        self._set_params(params_from_numpy(tree, self.device))
