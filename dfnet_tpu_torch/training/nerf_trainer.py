"""Stage 1 — NeRF-H training and evaluation (port of
dfnet_tpu/training/nerf_trainer.py).

Per epoch, for every train image in a shuffled order: sample N_rand
random pixels, render them through coarse + fine (the kernel path
render/fused_train.py, or the plain render/volume.py), NeRF-W loss plus
the proposal sampler's bound loss, backward, and an Adam update at
lr = lrate * 0.1^(global_step / (lrate_decay * 1000)), where global_step
advances once per epoch (the reference's schedule). Splits render at test
settings through render/fast.py or the plain renderer. Checkpoints hold
the params and the Adam state in the JAX package's layout.

Random draws come from explicit generators: `gen` (on the device) for the
pixel selection and the render's samples, a numpy generator for the
epoch order; the params are initialised from a CPU generator.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Callable, Dict, List, Optional, Tuple

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
from dfnet_tpu_torch.render.fused_train import (
    fused_train_supported,
    render_rays_train_fused,
)
from dfnet_tpu_torch.render.rays import get_rays
from dfnet_tpu_torch.render.volume import (
    NeRFHModel,
    RenderSettings,
    composite_nerfw,
    render_rays,
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


def _tree_map(fn: Callable, tree: Dict) -> Dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def stage1_loss(params: Dict, model: NeRFHModel, cfg: Config,
                settings: RenderSettings, rays_o, rays_d, target, hist,
                gen: Optional[torch.Generator], fused: bool,
                epoch: Optional[float] = None):
    """(loss, fine-rgb MSE) of one ray batch: the NeRF-W loss of the
    kernel (`fused`) or plain render, plus the proposal sampler's bound
    loss against the fine weights (which carry no gradient, so only the
    proposal learns from it). `epoch` sets the frequency window of the
    plain render's embedders under --reduce_embedding 2 and is dropped
    otherwise, as in the reference; the kernel render never windows
    (fused_train_supported refuses a windowed embedder)."""
    if fused:
        out = render_rays_train_fused(params, model, rays_o, rays_d, hist, settings, gen)
    else:
        ep = epoch if cfg.reduce_embedding == 2 else None
        out = render_rays(params, model, rays_o, rays_d, hist, settings, gen, epoch=ep)
    loss = sum(nerfw_loss(out, target).values())
    if model.cfg_proposal is not None and "proposal" in params and "weights_fine" in out:
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
                 gen: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.scene = scene
        self.device = resolve_device(device if device is not None else cfg.device)
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
        # which step serves this config: the kernels, or the plain render
        self.uses_fused_train = bool(
            cfg.fused_train and cfg.reduce_embedding != 2
            and fused_train_supported(self.model, self.settings, cfg.N_rand))
        self._build_render()

    def _set_params(self, params: Dict) -> None:
        """Adopt a params tree as trainable leaves with a fresh Adam."""
        self.params = _tree_map(lambda t: t.detach().float().requires_grad_(True),
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
        cfg, sc = self.cfg, self.scene
        if epoch is None:
            epoch = self.global_step
        rays_o, rays_d = get_rays(sc.H, sc.W, sc.focal, self._poses[idx])
        sel = torch.randperm(sc.H * sc.W, generator=self.gen,
                             device=self.device)[:cfg.N_rand]
        rays_o = rays_o.reshape(-1, 3)[sel]
        rays_d = rays_d.reshape(-1, 3)[sel]
        target = self._images[idx].reshape(-1, 3)[sel]
        hist = self._hists[idx]
        hist_b = hist[None].expand((rays_o.shape[0],) + hist.shape)
        loss, mse = stage1_loss(self.params, self.model, cfg, self.settings,
                                rays_o, rays_d, target, hist_b, self.gen,
                                self.uses_fused_train, epoch)
        if cfg.check_numerics:
            check_finite_loss(loss, f"the stage-1 step of epoch {epoch} on train image {idx}")
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.adam_update(lr)
        return loss.detach(), mse2psnr(mse.detach())

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
        """One pass over the shuffled train images at this epoch; returns
        the last step's (loss, psnr), as the reference does."""
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

        from dfnet_tpu_torch.render import fast as fast_mod
        from dfnet_tpu_torch.render.volume import render_image

        self.uses_fast_render = (cfg.fast_render and cfg.reduce_embedding != 2
                                 and fast_mod.fast_path_supported(
                                     model, self.settings_test))
        if self.uses_fast_render:
            def render_one(params, pose, hist, epoch):
                return fast_mod.render_image_fast(
                    params, model, pose, hist, eh, ew, ef, self.settings_test,
                    chunk=chunk, use_proposal=cfg.proposal_render,
                    **fast_mod.cull_schedule_kwargs(cfg))
        else:
            def render_one(params, pose, hist, epoch):
                ep = epoch if cfg.reduce_embedding == 2 else None
                return render_image(params, model, pose, hist, eh, ew, ef,
                                    self.settings_test, chunk=chunk, epoch=ep)
        self._render = render_one
        self._render_factor = rf

    def render_split(self, split, savedir: Optional[str] = None,
                     max_images: Optional[int] = None, stride: int = 1,
                     video_base: Optional[str] = None) -> float:
        """Render a split at test settings at epoch global_step (the
        reference's eval epoch: the epochs trained, or the checkpoint's
        step under --render_test); returns the mean PSNR. With savedir,
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
            if savedir:
                os.makedirs(savedir, exist_ok=True)
                write_png(osp.join(savedir, f"{j:03d}.png"), to8b(rgb))
                write_png(osp.join(savedir, f"{j:03d}_GT.png"), to8b(gt))
                write_png(osp.join(savedir, f"{j:03d}_disp.png"),
                          to8b(disp / max(disp.max(), 1e-8)))
        if video_base and rgbs:
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
            _tree_map(lambda t: mu[paths[id(t)]], self.params),
            _tree_map(lambda t: nu[paths[id(t)]], self.params))

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
