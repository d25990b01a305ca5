"""FrozenNeRF: the trained NeRF-H as a render service for stages 2 and 3
(port of dfnet_tpu/training/nerf_renderer.py).

Wraps (params, model, settings) with the per-scene world rescale applied
to APR-frame poses (pose/se3.py::rescale_poses_to_nerf) and the tinyimg
path: render at 1/tinyscale, then bicubic-upsample to full size.

  - render_at_pose / prerender_views: no-grad renders (stage-2 pre-renders,
    eval sweeps) through the CUDA kernels (render/fast.py::render_image_fast,
    the weights packed once per weight version in the object's PackCache)
    when cfg.fast_render and the model supports them, else the plain
    renderer;
  - render_fn / render_fn_batch: the plain renderer with autograd on,
    differentiable in the pose (stage 3). The kernels' train path returns
    no cotangents for the rays, so pose gradients never go through them.

A vanilla NeRF (NeRFH=False) renders through the plain renderer here
(render_image dispatches on the model), as in the JAX package, though the
stage-1 trainer's step and test render take the kernels for it
(training/nerf_trainer.py). Where the JAX package fails on one, a `.tar`
load and render_fn_batch, the port raises NotImplementedError instead.

With a mesh (parallel/mesh.py) every render splits its ray axis across
the ranks, as the JAX package's does: each rank renders its slice (the
no-grad renders through the kernels per rank, render_fn and
render_fn_batch through the plain renderer with autograd) and the slices
are gathered, differentiably, so a pose gradient reaches every rank's rays.

The JAX package's compile cache (aot_jit) has no counterpart: the kernels
are built once per source hash by ops/build.py.
"""

from __future__ import annotations

import os.path as osp
from typing import Dict, Optional

import numpy as np
import torch

from dfnet_tpu_torch.config import Config
from dfnet_tpu_torch.convert import convert_nerf_checkpoint
from dfnet_tpu_torch.device import resolve_device
from dfnet_tpu_torch.models.factory import create_nerfh, render_settings
from dfnet_tpu_torch.ops.resize import resize_bicubic
from dfnet_tpu_torch.parallel.mesh import gather_rows, row_counts, shard_rows
from dfnet_tpu_torch.pose.se3 import rescale_poses_to_nerf
from dfnet_tpu_torch.render import fast as fast_mod
from dfnet_tpu_torch.render.rays import get_rays
from dfnet_tpu_torch.render.volume import (
    NeRFHModel,
    VanillaNeRFModel,
    render_image_grad,
    render_rays,
)
from dfnet_tpu_torch.training.checkpoints import (
    latest_checkpoint,
    load_pytree,
    params_from_numpy,
)
from dfnet_tpu_torch.training.nerf_trainer import tree_map


class FrozenNeRF:
    VIEWS_PER_CALL = 8

    def __init__(self, cfg: Config, hwf, near: float, far: float,
                 world_setup: Dict, params: Optional[Dict] = None,
                 model: Optional[NeRFHModel] = None, mesh=None, device=None):
        self.cfg = cfg
        self.H, self.W = int(hwf[0]), int(hwf[1])
        self.focal = float(hwf[2])
        self.world_setup = world_setup
        self.mesh = mesh
        if device is None:
            device = mesh.device() if mesh is not None else cfg.device
        self.device = resolve_device(device)
        if model is None:
            model, init_params = create_nerfh(
                cfg, torch.Generator().manual_seed(cfg.rng_seed), self.device)
            params = params if params is not None else init_params
        self.model = model
        self.params = tree_map(torch.Tensor.detach, params)
        self.settings = render_settings(cfg, near, far, test=True)
        tiny = cfg.tinyimg
        ts = cfg.tinyscale if tiny else 1.0
        self.rh, self.rw = (int(self.H // ts), int(self.W // ts)) if tiny else (self.H, self.W)
        self.rf = self.focal / ts if tiny else self.focal
        self.chunk = min(cfg.chunk, self.rh * self.rw)
        # a vanilla pair stays on the plain renderer in stages 2 and 3, as in
        # the JAX package (ROADMAP.md, Queue 3), though the gate admits it
        self.uses_fast_render = bool(cfg.fast_render and isinstance(model, NeRFHModel)
                                     and fast_mod.kernels_serve(model, self.settings))
        self.packs = fast_mod.PackCache()

    @property
    def is_vanilla(self) -> bool:
        return isinstance(self.model, VanillaNeRFModel)

    # ------------------------------------------------------------- loading
    @classmethod
    def from_experiment(cls, cfg: Config, hwf, near, far, world_setup,
                        mesh=None, device=None) -> "FrozenNeRF":
        """Load the newest stage-1 checkpoint of <basedir>/<expname>
        (NNNNNN.npz, else the reference's NNNNNN.tar) or cfg.ft_path; random
        weights, with a warning, when there is none."""
        obj = cls(cfg, hwf, near, far, world_setup, mesh=mesh, device=device)
        path = cfg.ft_path
        if not path or path == "None":
            expdir = osp.join(cfg.basedir, cfg.expname)
            path = latest_checkpoint(expdir)
            if path is None:
                path = latest_checkpoint(expdir, pattern=r"^(\d+)\.tar$")
        if path and osp.exists(path) and not cfg.no_reload:
            obj.load(path)
        else:
            print("[FrozenNeRF] WARNING: no NeRF checkpoint found — random weights")
        return obj

    def load(self, path: str):
        """Adopt a checkpoint's params: the shared `.npz`, or the
        reference's `.tar` (convert.py, at depth cfg.netdepth). A `.tar`
        holds no proposal net, so the kernel renders then place their
        samples with the coarse net (render/fast.py::FastNeRFH.pack). A
        vanilla model takes no `.tar`: the JAX package converts every `.tar`
        as NeRF-W, which a vanilla one is not."""
        if path.endswith(".tar") and self.is_vanilla:
            raise NotImplementedError(
                f"{path}: a vanilla-NeRF (NeRFH=False) .tar does not load. The JAX "
                "package's FrozenNeRF.load converts every .tar as NeRF-W "
                "(dfnet_tpu/training/nerf_renderer.py:67-71, dfnet_tpu/convert.py:54-72) "
                "and fails with KeyError on the xyz_encoding_* keys a vanilla .tar "
                "lacks (ROADMAP.md, Queue 3)")
        if path.endswith(".tar"):
            params, _ = convert_nerf_checkpoint(path, D=self.cfg.netdepth)
        else:
            tree, _ = load_pytree(path)
            params = tree["params"] if "params" in tree else tree
        self.params = params_from_numpy(params, self.device)
        print(f"[FrozenNeRF] loaded {path}")

    # ------------------------------------------------------------- render
    def _to_nerf(self, pose_apr: torch.Tensor) -> torch.Tensor:
        ws = self.world_setup
        return rescale_poses_to_nerf(pose_apr, ws["pose_scale"], ws["move_all_cam_vec"],
                                     ws["pose_scale2"])

    def _upsample(self, rgb: torch.Tensor) -> torch.Tensor:
        return resize_bicubic(rgb, self.H, self.W) if self.cfg.tinyimg else rgb

    def render_fn(self, params: Dict, pose_apr: torch.Tensor,
                  hist: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) rgb at the APR-frame (3, 4) pose through the plain
        renderer, differentiable in the pose and the params."""
        out = render_image_grad(params, self.model, self._to_nerf(pose_apr), hist,
                                self.rh, self.rw, self.rf, self.settings,
                                chunk=self.chunk, mesh=self.mesh)
        return self._upsample(out["rgb"])

    def render_fn_batch(self, params: Dict, poses_apr: torch.Tensor,
                        hists: torch.Tensor) -> torch.Tensor:
        """(B, 3, 4) poses, (B, hist_bin) hists -> (B, H, W, 3), the batched
        render_fn: the rays of all B views form one stream, rendered in
        chunks, differentiable in the poses. Per-ray math is render_fn's. A
        vanilla model raises NotImplementedError, where the JAX package's
        render_batch_grad calls the NeRF-H render_rays and fails with
        KeyError."""
        if self.is_vanilla:
            raise NotImplementedError(
                "FrozenNeRF.render_fn_batch over a vanilla NeRF (NeRFH=False): the JAX "
                "package's render_batch_grad calls the NeRF-H render_rays "
                "(dfnet_tpu/training/nerf_renderer.py:141-166) and fails with KeyError "
                "(ROADMAP.md, Queue 3)")
        b, hw = poses_apr.shape[0], self.rh * self.rw
        rays = [get_rays(self.rh, self.rw, self.rf, p) for p in self._to_nerf(poses_apr)]
        ro = torch.stack([o for o, _ in rays]).reshape(-1, 3)
        rd = torch.stack([d for _, d in rays]).reshape(-1, 3)
        hist_r = hists.repeat_interleave(hw, 0)
        if self.mesh is not None:
            lo, hi = shard_rows(ro.shape[0])
            ro, rd, hist_r = ro[lo:hi], rd[lo:hi], hist_r[lo:hi]
        ck = min(self.chunk, ro.shape[0])
        rgb = torch.cat([render_rays(params, self.model, o, d, h, self.settings)["rgb"]
                         for o, d, h in zip(ro.split(ck), rd.split(ck),
                                            hist_r.split(ck))], 0)
        if self.mesh is not None:
            rgb = gather_rows(rgb, row_counts(b * hw))
        return self._upsample(rgb.reshape(b, self.rh, self.rw, 3))

    @torch.no_grad()
    def render_at_pose(self, pose_apr, hist) -> torch.Tensor:
        """(H, W, 3) rgb at the given APR-frame pose, without gradients:
        the kernels when they serve this model, else the plain renderer."""
        pose_apr = torch.as_tensor(pose_apr, dtype=torch.float32, device=self.device)
        hist = torch.as_tensor(hist, device=self.device)
        if not self.uses_fast_render:
            return self.render_fn(self.params, pose_apr, hist)
        cfg = self.cfg
        out = fast_mod.render_image_fast(
            self.params, self.model, self._to_nerf(pose_apr), hist, self.rh, self.rw,
            self.rf, self.settings, chunk=self.chunk, use_proposal=cfg.proposal_render,
            packs=self.packs, mesh=self.mesh, **fast_mod.cull_schedule_kwargs(cfg))
        return self._upsample(out["rgb"])

    def prerender_views(self, poses: np.ndarray, hists: np.ndarray,
                        log_every: int = 10) -> np.ndarray:
        """Render every view (the reference's render_nerfw_imgs), in calls
        of VIEWS_PER_CALL views; the last call is padded with the last view.
        Returns (N, H, W, 3) float32 numpy."""
        n = poses.shape[0]
        v = self.VIEWS_PER_CALL
        pad = -n % v
        if pad:
            poses = np.concatenate([poses, np.repeat(poses[-1:], pad, 0)], 0)
            hists = np.concatenate([hists, np.repeat(hists[-1:], pad, 0)], 0)
        outs = []
        for i in range(0, n + pad, v):
            if log_every and i % max(log_every, v) == 0:
                print(f"renders {i}/total {n}")
            outs.append(torch.stack([self.render_at_pose(p, h) for p, h in
                                     zip(poses[i:i + v], hists[i:i + v])]).cpu().numpy())
        return np.concatenate(outs, 0)[:n].astype(np.float32)

