"""Stage 3 — DFNet_dm direct feature matching (port of
dfnet_tpu/training/dm_trainer.py).

Per image (batch 1): the pose model F predicts a pose (SVD-projected onto
rotations under svd_reg); the frozen NeRF renders at that pose through
the plain renderer (FrozenNeRF.render_fn: tinyimg at 1/4, bicubic up);
the frozen feature model G extracts siamese features of [real; render];
the loss w0·poseMSE + w1·photoMSE + w2·cosineFeature backpropagates
through the renderer into the predicted pose and updates F only, with
torch.optim.Adam over every leaf of F (optax.adam's semantics: no BN
mask). With combine_loss_w = [0, 0, 1] the stage is self-supervised.

The renders of this stage run no CUDA kernel: the kernels' train path
(render/fused_train.py::RawSweep) returns no cotangents for the rays, so
a pose gradient must go through the plain render_rays, as in the JAX
package. G's and the NeRF's tensors do not require grad, so backward
builds no gradient for them.

`--dm_batch_size K > 1`: K images a step, their rays one stream through
FrozenNeRF.render_fn_batch, one Adam update on the mean of the per-image
losses; an epoch's n % K tail goes through the per-image step. The val
metrics render N_rand random rays of each val view at the predicted pose
(float32 DFNet, no grad), drawn from the trainer's seeded generator.

Images live on the device as (N, H, W, 3) float32, the layout of the
renders and of the JAX package; DFNet reads them as NCHW views. Under
`--prefetch N` the train split stays on the host, and each step's images,
poses and hists reach the device through data/prefetch.py, N steps ahead. Float32
steps run forward and backward inside models/dfnet.py::conv_precision.
"""

from __future__ import annotations

import functools
import os.path as osp
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dfnet_tpu_torch.config import Config, check_finite_loss
from dfnet_tpu_torch.data.prefetch import PrefetchIterator
from dfnet_tpu_torch.data.scene import SceneData
from dfnet_tpu_torch.device import resolve_device
from dfnet_tpu_torch.models.dfnet import (
    DFNet,
    DFNetConfig,
    conv_precision,
    dfnet_forward,
    dfnet_params_to_jax,
)
from dfnet_tpu_torch.models.losses import img2mse, mse2psnr
from dfnet_tpu_torch.pose.se3 import project_rotation_svd, rescale_poses_to_nerf
from dfnet_tpu_torch.render.rays import get_rays
from dfnet_tpu_torch.render.volume import render_rays
from dfnet_tpu_torch.training.callbacks import EarlyStopping
from dfnet_tpu_torch.training.checkpoints import ADAM_HYPER
from dfnet_tpu_torch.training.eval_pose import get_error_in_q
from dfnet_tpu_torch.training.feature_losses import cosine_feature_loss, pose_loss
from dfnet_tpu_torch.training.feature_trainer import load_dfnet_params
from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF
from dfnet_tpu_torch.training.nerf_trainer import named_leaves


def select_levels_for_loss(feats: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    """(L, B, C, H, W) -> (B, L'*C, H*W): the selected levels, level-major
    and channels first, as the JAX package orders them from its
    (L, B, H, W, C) features (preprocess_features_for_loss)."""
    sel = feats[list(levels)]                           # (L', B, C, H, W)
    L, B, C, H, W = sel.shape
    return sel.transpose(0, 1).reshape(B, L * C, H * W)


def refuse_unported(cfg: Config) -> None:
    """Raise for what stage 3 needs and later slices of the port bring."""
    if not cfg.pretrain_model_path:
        raise ValueError("stage 3 requires a pretrained DFNet (--pretrain_model_path)")
    if int(cfg.mesh_shape or 1) > 1:
        raise NotImplementedError(
            "a device mesh (multi-GPU training) is not ported yet (ROADMAP.md, "
            "Queue 1 item 10)")


class DMTrainer:
    EVAL_CHUNK = 8

    def __init__(self, cfg: Config, scene: SceneData, nerf: FrozenNeRF,
                 device=None, gen: Optional[torch.Generator] = None):
        refuse_unported(cfg)
        self.cfg = cfg
        self.scene = scene
        self.nerf = nerf
        self.device = resolve_device(device if device is not None else cfg.device)
        self.model_cfg = DFNetConfig.small() if cfg.DFNet_s else DFNetConfig()
        self.compute_dtype = (torch.bfloat16 if cfg.feature_precision == "bf16"
                              else torch.float32)
        # dm's default is two weights; the loss takes three, zero-padded
        self.loss_w = (list(cfg.combine_loss_w) + [0.0, 0.0, 0.0])[:3]

        # pose model F (trainable) and feature model G (frozen)
        params, state = load_dfnet_params(cfg.pretrain_model_path, self.device)
        self.net = DFNet(params, state, self.model_cfg)
        feat_path = cfg.pretrain_featurenet_path or cfg.pretrain_model_path
        self.feat_params, self.feat_state = load_dfnet_params(feat_path, self.device)
        self._named = named_leaves(self.params)
        self.optimizer = torch.optim.Adam(
            [t for _, t in self._named], lr=cfg.learning_rate,
            betas=(ADAM_HYPER["b1"], ADAM_HYPER["b2"]), eps=ADAM_HYPER["eps"])
        self.early_stopping = EarlyStopping(
            osp.join(cfg.basedir, cfg.model_name or "dfnetdm"),
            patience=cfg.patience[0], val_on_psnr=cfg.val_on_psnr)
        self.gen = gen if gen is not None else torch.Generator().manual_seed(cfg.rng_seed)
        self.val_data = self._split(scene.val)
        self.steps = 0

    @property
    def params(self) -> Dict:
        return self.net.params

    @property
    def state(self) -> Dict:
        return self.net.state

    @functools.cached_property
    def train_data(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The train split on the device, built at first use: train_epoch
        under --prefetch never uses it."""
        return self._split(self.scene.train)

    def images(self, images) -> torch.Tensor:
        """(N, H, W, 3) numpy images -> float32 on the trainer's device."""
        return torch.as_tensor(np.asarray(images, np.float32)).to(self.device)

    def _split(self, split) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """A split's images, (N, 12) poses and hists on the device."""
        n = len(split)
        return (self.images(split.images),
                torch.as_tensor(split.poses.reshape(n, 12), dtype=torch.float32,
                                device=self.device),
                torch.as_tensor(split.hists, device=self.device))

    # ------------------------------------------------------------- loss
    def predict_poses(self, params: Dict, images: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(K, H, W, 3) images -> (K, 3, 4) poses: F (eval-mode BN) in
        `dtype`, then the SVD projection under svd_reg."""
        _, pose12, _ = dfnet_forward(params, self.state, images.permute(0, 3, 1, 2),
                                     self.model_cfg, return_feature=False,
                                     upsample_h=self.scene.H, upsample_w=self.scene.W,
                                     compute_dtype=dtype)
        poses = pose12.reshape(-1, 3, 4)
        return project_rotation_svd(poses) if self.cfg.svd_reg else poses

    def render(self, nerf_params: Dict, poses: torch.Tensor,
               hists: torch.Tensor) -> torch.Tensor:
        """(K, H, W, 3) renders at (K, 3, 4) APR-frame poses, differentiable
        in the poses: render_fn for one view, else render_fn_batch."""
        if poses.shape[0] == 1:
            return self.nerf.render_fn(nerf_params, poses[0], hists[0])[None]
        return self.nerf.render_fn_batch(nerf_params, poses, hists)

    def match_losses(self, poses: torch.Tensor, rgbs: torch.Tensor, feat_params: Dict,
                     images: torch.Tensor, poses_gt12: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-image (losses, psnrs), each (K,): G's siamese features of
        [images; renders] on the selected levels, the cosine feature loss,
        the photometric MSE and the pose MSE, weighted by loss_w."""
        k = images.shape[0]
        x = torch.cat([images, rgbs], 0).permute(0, 3, 1, 2)
        (f_t, f_r), _, _ = dfnet_forward(
            feat_params, self.feat_state, x, self.model_cfg, return_feature=True,
            is_single_stream=False, return_pose=False, upsample_h=self.scene.H,
            upsample_w=self.scene.W, compute_dtype=self.compute_dtype)
        levels = self.cfg.feature_matching_lvl
        f_t, f_r = select_levels_for_loss(f_t, levels), select_levels_for_loss(f_r, levels)
        feat_l = torch.stack([cosine_feature_loss(f_r[i], f_t[i], self.cfg.per_channel)
                              for i in range(k)])
        photo_l = torch.mean((rgbs - images) ** 2, dim=(1, 2, 3))
        pose_l = torch.mean((poses.reshape(k, 12) - poses_gt12) ** 2, dim=1)
        w = self.loss_w
        return w[0] * pose_l + w[1] * photo_l + w[2] * feat_l, mse2psnr(photo_l)

    def batched_loss_fn(self, params: Dict, nerf_params: Dict, feat_params: Dict,
                        images, poses_gt12, hists):
        """(mean loss, (per-image losses, psnrs)) of K images (K, H, W, 3),
        (K, 12) poses, (K, hist_bin) hists, differentiable in `params`."""
        poses = self.predict_poses(params, images, self.compute_dtype)
        rgbs = self.render(nerf_params, poses, hists)
        losses, psnrs = self.match_losses(poses, rgbs, feat_params, images, poses_gt12)
        return losses.mean(), (losses, psnrs)

    def loss_fn(self, params: Dict, nerf_params: Dict, feat_params: Dict, image,
                pose_gt12, hist):
        """(loss, psnr) of one image (H, W, 3) with its (1, 12) pose and
        (hist_bin,) hist: the K = 1 case of batched_loss_fn."""
        _, (losses, psnrs) = self.batched_loss_fn(params, nerf_params, feat_params,
                                                  image[None], pose_gt12, hist[None])
        return losses[0], psnrs[0]

    # ------------------------------------------------------------- update
    def adam_update(self) -> None:
        """Adam at learning_rate on every leaf of F, as optax.adam: a leaf
        without a grad (F's adapt branch, unused by the pose forward)
        takes a zero one."""
        for _, t in self._named:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        self.optimizer.step()

    def _update(self, loss_fn, *args):
        """One Adam update on loss_fn(params, *args) -> (loss, aux); the
        backward reads the precision flags when it runs, so a float32 step
        keeps them as its forward has them. Returns (loss, aux), detached."""
        with conv_precision(self.compute_dtype):
            self.optimizer.zero_grad(set_to_none=True)
            loss, aux = loss_fn(self.params, *args)
            if self.cfg.check_numerics:
                check_finite_loss(loss, f"stage-3 step {self.steps}")
            loss.backward()
        self.adam_update()
        self.steps += 1
        aux = tuple(a.detach() for a in aux) if isinstance(aux, tuple) else aux.detach()
        return loss.detach(), aux

    def train_step(self, images, poses_gt12, hists) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update on K images; (per-image losses, psnrs), detached."""
        _, (losses, psnrs) = self._update(
            lambda p, *a: self.batched_loss_fn(p, self.nerf.params, self.feat_params, *a),
            images, poses_gt12, hists)
        return losses, psnrs

    # ------------------------------------------------------------- variants
    def draw_rays(self) -> torch.Tensor:
        """N_rand pixel indices of an H x W view without repeats, from the
        trainer's generator."""
        hw = self.scene.H * self.scene.W
        return torch.randperm(hw, generator=self.gen)[:self.cfg.N_rand].to(self.device)

    def _rays_at(self, pose: torch.Tensor, sel: torch.Tensor):
        """The selected rays of a view at an APR-frame (3, 4) pose."""
        ws = self.scene.world_setup
        pose_nerf = rescale_poses_to_nerf(pose, ws["pose_scale"], ws["move_all_cam_vec"],
                                          ws["pose_scale2"])
        ro, rd = get_rays(self.scene.H, self.scene.W, self.scene.focal, pose_nerf)
        return ro.reshape(-1, 3)[sel], rd.reshape(-1, 3)[sel]

    def photometric_loss_fn(self, params: Dict, image, pose_gt12, hist, sel):
        """(loss, psnr) of the Direct-PoseNet-lineage photometric step: rgb
        MSE on the rays `sel` rendered at the predicted pose, plus the pose
        MSE under combine_loss_w[:2] (the photometric MSE alone when it has
        fewer than two weights)."""
        pose = self.predict_poses(params, image[None], self.compute_dtype)
        nerf = self.nerf
        ro, rd = self._rays_at(pose[0], sel)
        out = render_rays(nerf.params, nerf.model, ro, rd,
                          hist[None].expand((len(sel),) + hist.shape), nerf.settings)
        photo_l = img2mse(out["rgb"], image.reshape(-1, 3)[sel])
        pose_l = pose_loss(pose.reshape(1, 12), pose_gt12)
        w = self.cfg.combine_loss_w
        loss = w[0] * pose_l + w[1] * photo_l if len(w) >= 2 else photo_l
        return loss, mse2psnr(photo_l)

    def feature_nerf_loss_fn(self, feature_nerf: FrozenNeRF, params: Dict, image,
                             pose_gt12, hist, sel):
        """(loss, psnr) of the feature-field step: a NeRF of 3 + C output
        channels renders the rays `sel` at the predicted pose; its C feature
        channels are matched (cosine) against G's level-0 features at those
        pixels, plus photometric and pose MSE under combine_loss_w."""
        H, W = self.scene.H, self.scene.W
        pose = self.predict_poses(params, image[None], self.compute_dtype)
        ro, rd = self._rays_at(pose[0], sel)
        out = render_rays(feature_nerf.params, feature_nerf.model, ro, rd,
                          hist[None].expand((len(sel),) + hist.shape),
                          feature_nerf.settings)
        rgb, feat_render = out["rgb"][:, :3], out["rgb"][:, 3:].T      # (C, N)
        (feats,), _, _ = dfnet_forward(
            self.feat_params, self.feat_state, image[None].permute(0, 3, 1, 2),
            self.model_cfg, return_feature=True, is_single_stream=True,
            return_pose=False, upsample_h=H, upsample_w=W,
            compute_dtype=self.compute_dtype)
        f0 = feats[0, 0].reshape(feats.shape[2], H * W)[:, sel]        # (C, N)
        photo_l = img2mse(rgb, image.reshape(-1, 3)[sel])
        feat_l = cosine_feature_loss(feat_render, f0, per_channel=self.cfg.per_channel)
        pose_l = pose_loss(pose.reshape(1, 12), pose_gt12)
        w = self.cfg.combine_loss_w
        return w[0] * pose_l + w[1] * photo_l + w[2] * feat_l, mse2psnr(photo_l)

    def build_photometric_step(self):
        """step(image, pose_gt12, hist, sel) -> (loss, psnr): one Adam update
        on photometric_loss_fn (reference direct_pose_model.py, the
        train_nerf_tracking lineage; no shipped config reaches it)."""
        return functools.partial(self._update, self.photometric_loss_fn)

    def build_feature_nerf_step(self, feature_nerf: FrozenNeRF):
        """step(image, pose_gt12, hist, sel) -> (loss, psnr): one Adam update
        on feature_nerf_loss_fn (reference train_on_feature_batch; needs a
        feature-output NeRF, which no shipped config trains)."""
        return functools.partial(self._update,
                                 functools.partial(self.feature_nerf_loss_fn, feature_nerf))

    def train_epoch_photometric(self, step_fn, rng: np.random.Generator
                                ) -> Tuple[float, float]:
        """One epoch of step_fn (build_photometric_step's) in rng's order,
        N_rand fresh rays an image; the mean (loss, psnr)."""
        images, poses12, hists = self.train_data
        out = [step_fn(images[i], poses12[i:i + 1], hists[i], self.draw_rays())
               for i in rng.permutation(len(images))]
        return self._means(torch.stack([l for l, _ in out]), torch.stack([p for _, p in out]))

    # ------------------------------------------------------------- epochs
    @staticmethod
    def _means(losses: torch.Tensor, psnrs: torch.Tensor) -> Tuple[float, float]:
        """Host means of an epoch's per-step values, read back once."""
        return (float(np.mean(losses.cpu().numpy())),
                float(np.mean(psnrs.cpu().numpy())))

    def train_epoch(self, rng: np.random.Generator) -> Tuple[float, float]:
        """One epoch in the order rng.permutation gives: full K-image
        batches, then the n % K tail one image a step, so every image
        trains each epoch. Returns the mean (loss, psnr) over images."""
        order = rng.permutation(len(self.scene.train))
        k = self.cfg.dm_batch_size
        n_full = (len(order) // k) * k if k > 1 else 0
        steps = [order[s:s + k] for s in range(0, n_full, k)]
        steps += [order[i:i + 1] for i in range(n_full, len(order))]
        if self.cfg.prefetch > 0:
            tr = self.scene.train
            it = PrefetchIterator(
                lambda idx: (tr.images[idx], tr.poses[idx].reshape(len(idx), 12),
                             tr.hists[idx]),
                steps, depth=self.cfg.prefetch, device=self.device)
        else:
            images, poses12, hists = self.train_data
            it = ((images[i], poses12[i], hists[i])
                  for i in (torch.as_tensor(idx, device=self.device) for idx in steps))
        losses, psnrs = [], []
        for batch in it:
            ls, ps = self.train_step(*batch)
            losses.append(ls)
            psnrs.append(ps)
        return self._means(torch.cat(losses), torch.cat(psnrs))

    @torch.no_grad()
    def predict12(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 12) poses of (B, H, W, 3) device images: F in float32 with
        eval-mode BN whatever feature_precision, no SVD (the eval path)."""
        _, pose12, _ = dfnet_forward(self.params, self.state, images.permute(0, 3, 1, 2),
                                     self.model_cfg, return_feature=False)
        return pose12

    @torch.no_grad()
    def eval_epoch(self) -> Tuple[float, float]:
        """Val pose MSE and PSNR at the predicted pose, averaged over the
        val views (eval_on_epoch): F in float32 on EVAL_CHUNK views a call,
        the SVD projection under svd_reg, then N_rand random rays of every
        view rendered as one stream in chunks of cfg.chunk."""
        images, poses12, hists = self.val_data
        n, nerf = len(images), self.nerf
        pred = torch.cat([self.predict12(x) for x in images.split(self.EVAL_CHUNK)])
        poses = pred.reshape(n, 3, 4)
        if self.cfg.svd_reg:
            poses = project_rotation_svd(poses)
        pose_l = torch.mean((poses.reshape(n, 12) - poses12) ** 2, dim=1)
        sels = [self.draw_rays() for _ in range(n)]
        rays = [self._rays_at(p, s) for p, s in zip(poses, sels)]
        ro = torch.cat([o for o, _ in rays])
        rd = torch.cat([d for _, d in rays])
        hist_r = torch.cat([h[None].expand(len(s), -1) for h, s in zip(hists, sels)])
        ck = self.cfg.chunk
        rgb = torch.cat([render_rays(nerf.params, nerf.model, o, d, h, nerf.settings)["rgb"]
                         for o, d, h in zip(ro.split(ck), rd.split(ck), hist_r.split(ck))])
        target = torch.stack([im.reshape(-1, 3)[s] for im, s in zip(images, sels)])
        mse = torch.mean((rgb.reshape(target.shape) - target) ** 2, dim=(1, 2))
        return self._means(pose_l, mse2psnr(mse))

    def eval_median_error(self, split=None):
        split = split if split is not None else self.scene.val
        return get_error_in_q(lambda imgs: self.predict12(self.images(imgs)), split)

    def checkpoint_tree(self) -> Dict:
        params, state = dfnet_params_to_jax(self.params, self.state)
        return {"params": params, "state": state}
