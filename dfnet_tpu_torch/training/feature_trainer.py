"""Stage 2 — DFNet training with Random View Synthesis (port of
dfnet_tpu/training/feature_trainer.py).

  - pre-render every train view once through the frozen NeRF (FrozenNeRF,
    whose no-grad renders run the coarse_sigma_t and fine_raw_t kernels);
  - every rvs_refresh_rate epochs, perturb each train pose (rotation
    ±rvs_rotation deg, translation ±rvs_trans, clamped to the train camera
    volume ±d_max) and render the virtual views;
  - per batch: siamese DFNet on [GT images; NeRF renders; RVS views] with
    feature_count=2B -> pose MSE on the doubled GT poses + triplet feature
    loss (hard-negative-mining-plus) + pose MSE of the RVS views, weighted
    by combine_loss_w; then backward and torch.optim.Adam;
  - val pose MSE per epoch -> ReduceLROnPlateau + EarlyStopping;
  - median pose error (get_error_in_q) every i_eval epochs.

BN runs in batch-stat mode unless freezeBN (then eval-mode stats, and the
BN affine's gradients are zeroed, so Adam leaves it bit-identical).
Images live on the device as (N, 3, H, W) float32; the per-step loss stays
a device tensor and an epoch's losses are read once at its end. Under
`--prefetch N` the train images stay on the host and each batch reaches
the device through data/prefetch.py, N batches ahead of the step.
Checkpoints are the JAX package's flat npz {"params", "state"} in its
layout, so each package loads the other's.

With a mesh (parallel/mesh.py) a step keeps the global batch's semantics:
each rank runs the VGG16 encoder on its share of the siamese images and
of the RVS views, the pooled features and the three taps are gathered
back into one-device order (the taps of the siamese rows only), and the
adapt branch,
BatchNorm (so its statistics are the whole batch's), the upsample, the
rolled triplet negatives, the hard-negative choice and the pose head run
replicated on every rank. The gather's backward hands rank r the sum of
every rank's cotangents of its rows, n times its share, so the grads
averaged over ranks are the one-device grads. Validation, the median
error and the pre-render's consumers stay replicated (the renders
themselves split their ray axis in FrozenNeRF).
"""

from __future__ import annotations

import os.path as osp
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dfnet_tpu_torch.config import Config, check_finite_loss
from dfnet_tpu_torch.convert import convert_dfnet_checkpoint, convert_vgg16_imagenet
from dfnet_tpu_torch.data.prefetch import PrefetchIterator
from dfnet_tpu_torch.data.scene import SceneData
from dfnet_tpu_torch.device import resolve_device
from dfnet_tpu_torch.models.dfnet import (
    DFNet,
    DFNetConfig,
    dfnet_encode,
    dfnet_forward,
    dfnet_head,
    dfnet_params_from_jax,
    dfnet_params_to_jax,
    conv_precision,
    init_dfnet_params,
)
from dfnet_tpu_torch.parallel.mesh import (
    all_reduce_grads_,
    gather_rows,
    row_counts,
    shard_rows,
)
from dfnet_tpu_torch.pose import perturb_single_render_pose
from dfnet_tpu_torch.training.callbacks import EarlyStopping, ReduceLROnPlateau
from dfnet_tpu_torch.training.checkpoints import ADAM_HYPER, load_pytree
from dfnet_tpu_torch.training.eval_pose import get_error_in_q
from dfnet_tpu_torch.training.feature_losses import (
    feature_mse,
    pose_loss,
    triplet_axis,
    triplet_loss_hard_negative_mining_plus,
)
from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF
from dfnet_tpu_torch.training.nerf_trainer import named_leaves


def load_dfnet_params(path: str, device="cpu") -> Tuple[Dict, Dict]:
    """(params, state) of a DFNet checkpoint as the port's tensors on
    `device`: a `.npz` in the JAX package's layout, written by either
    package, or the reference's `.pt` (convert.py)."""
    if path.endswith(".pt"):
        return convert_dfnet_checkpoint(path, device)
    tree, _ = load_pytree(path)
    return dfnet_params_from_jax(tree["params"], tree["state"], device)


class FeatureTrainer:
    def __init__(self, cfg: Config, scene: SceneData, nerf: Optional[FrozenNeRF],
                 device=None, gen: Optional[torch.Generator] = None, mesh=None):
        self.cfg = cfg
        self.scene = scene
        self.nerf = nerf
        self.mesh = mesh
        if device is None:
            device = mesh.device() if mesh is not None else cfg.device
        self.device = resolve_device(device)
        self.model_cfg = DFNetConfig.small() if cfg.DFNet_s else DFNetConfig()
        if gen is None:
            gen = torch.Generator().manual_seed(cfg.rng_seed)
        params, state = init_dfnet_params(gen, self.model_cfg, self.device)
        if cfg.vgg_init_path:
            params["encoder"] = convert_vgg16_imagenet(cfg.vgg_init_path, self.device)
            print(f"[dfnet] ImageNet VGG16 init from {cfg.vgg_init_path}")
        if cfg.pretrain_model_path:
            params, state = load_dfnet_params(cfg.pretrain_model_path, self.device)
            print(f"[dfnet] loaded pretrained {cfg.pretrain_model_path}")
        self.net = DFNet(params, state, self.model_cfg)
        self._named = named_leaves(self.params)
        self.optimizer = torch.optim.Adam(
            [t for _, t in self._named], lr=cfg.learning_rate,
            betas=(ADAM_HYPER["b1"], ADAM_HYPER["b2"]), eps=ADAM_HYPER["eps"])
        self.scheduler = ReduceLROnPlateau(cfg.learning_rate, factor=0.95,
                                           patience=cfg.patience[1])
        self.early_stopping = EarlyStopping(
            osp.join(cfg.basedir, cfg.model_name or "dfnet"),
            patience=cfg.patience[0], val_on_psnr=cfg.val_on_psnr)
        # the reference-exact triplet axis (the reference reduces the
        # pairwise distance over image W): auto-on when fine-tuning a
        # .pt-ported released checkpoint, else the channel axis
        ref_axis = cfg.triplet_ref_axis
        if ref_axis is None:
            ref_axis = bool(cfg.pretrain_model_path
                            and cfg.pretrain_model_path.endswith(".pt"))
        self.triplet_axis = triplet_axis(ref_axis)
        self.steps = 0
        self.compute_dtype = (torch.bfloat16 if cfg.feature_precision == "bf16"
                              else torch.float32)
        self._train_poses12 = torch.as_tensor(
            scene.train.poses.reshape(-1, 12), dtype=torch.float32, device=self.device)
        self._val_images = None

    @property
    def params(self) -> Dict:
        return self.net.params

    @property
    def state(self) -> Dict:
        return self.net.state

    def images(self, images) -> torch.Tensor:
        """(N, H, W, 3) numpy images -> (N, 3, H, W) float32 on the
        trainer's device; a tensor is taken as already there."""
        if isinstance(images, torch.Tensor):
            return images
        t = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
        return t.permute(0, 3, 1, 2).contiguous()

    def epoch_images(self, images):
        """(N, H, W, 3) numpy images in the form train_epoch takes: as they
        are under --prefetch (the prefetcher copies each batch), else on
        the device (`images`)."""
        return np.asarray(images, np.float32) if self.cfg.prefetch > 0 else self.images(images)

    # ------------------------------------------------------------- step
    def loss_fn(self, params: Dict, state: Dict, targets, rgbs, poses12,
                rgb_perturb=None, pose_perturb12=None):
        """(loss, new_state) of one batch, differentiable in `params`.
        Images (B, 3, H, W); the RVS views ride the siamese pair's encoder
        batch, and feature_count=2B keeps them out of the adapt branch and
        its BN statistics."""
        cfg, w = self.cfg, self.cfg.combine_loss_w
        nb = targets.shape[0]
        rvs = cfg.random_view_synthesis
        x = torch.cat([targets, rgbs] + ([rgb_perturb] if rvs else []), 0)
        kw = dict(return_feature=True, is_single_stream=False, feature_count=2 * nb,
                  upsample_h=self.scene.H, upsample_w=self.scene.W,
                  train_bn=not cfg.freezeBN, compute_dtype=self.compute_dtype)
        if self.mesh is None:
            (f_t, f_r), predict, new_state = dfnet_forward(params, state, x,
                                                           self.model_cfg, **kw)
        else:
            pooled, taps = self.encode_sharded(params, x, 2 * nb)
            (f_t, f_r), predict, new_state = dfnet_head(params, state, pooled, taps,
                                                        self.model_cfg, **kw)
        loss_pose = pose_loss(predict[:2 * nb], torch.cat([poses12, poses12], 0))
        if cfg.tripletloss:
            loss_f = triplet_loss_hard_negative_mining_plus(
                f_r, f_t, margin=cfg.triplet_margin, axis=self.triplet_axis)
        else:
            loss_f = feature_mse(f_r, f_t)
        if rvs:
            loss_rvs = pose_loss(predict[2 * nb:], pose_perturb12)
            return w[0] * loss_pose + w[1] * loss_f + w[2] * loss_rvs, new_state
        if cfg.poselossonly:
            return loss_pose, new_state
        if cfg.featurelossonly:
            return loss_f, new_state
        return loss_pose + loss_f, new_state

    def encode_sharded(self, params: Dict, x: torch.Tensor, n_feat: int):
        """dfnet_encode of the images x on a mesh: every rank gets the
        (N, 512) pooled features and the taps of the first n_feat images
        (the adapt branch's), in x's order. Each rank encodes its share of
        those n_feat images and its share of the rest (the pose-only RVS
        views), so the taps, the bulk of the bytes, split evenly; they ride
        one all-gather in their compute dtype, every image's float32 pooled
        features a second."""
        n = x.shape[0]
        lo, hi = shard_rows(n_feat)
        lo2, hi2 = shard_rows(n - n_feat)
        mine = torch.cat([x[lo:hi], x[n_feat + lo2:n_feat + hi2]], 0)
        pooled, taps = dfnet_encode(params, mine, self.model_cfg,
                                    compute_dtype=self.compute_dtype)
        k = hi - lo
        flat = torch.cat([t[:k].flatten(1) for t in taps], 1)
        parts = gather_rows(flat, row_counts(n_feat)).split(
            [t[0].numel() for t in taps], 1)
        all_taps = [part.reshape((n_feat,) + t.shape[1:]) for part, t in zip(parts, taps)]
        # rank r sends its feature images' pooled rows, then its other
        # images': regroup them into x's order
        cf, cr = row_counts(n_feat), row_counts(n - n_feat)
        got = gather_rows(pooled, [a + b for a, b in zip(cf, cr)]).split(
            [c for pair in zip(cf, cr) for c in pair])
        all_pooled = torch.cat(got[0::2] + got[1::2], 0)
        return all_pooled, all_taps

    def train_step(self, targets, rgbs, poses12, rgb_perturb, pose_perturb12,
                   lr: float) -> torch.Tensor:
        """One update; returns the loss as a device tensor."""
        loss, new_state = self.loss_and_grads(targets, rgbs, poses12, rgb_perturb,
                                              pose_perturb12)
        self.net.state = new_state
        self.adam_update(lr)
        self.steps += 1
        return loss

    def loss_and_grads(self, targets, rgbs, poses12, rgb_perturb=None,
                       pose_perturb12=None):
        """(loss, new_state) of one batch, the loss detached and its grads
        in the leaves' .grad (on a mesh, averaged over the ranks: the
        batch's grads on every rank)."""
        # the backward's convs read the precision flags when they run, so a
        # float32 step keeps them as its forward has them
        with conv_precision(self.compute_dtype):
            loss, new_state = self.loss_fn(self.params, self.state, targets, rgbs,
                                           poses12, rgb_perturb, pose_perturb12)
            if self.cfg.check_numerics:
                check_finite_loss(loss, f"stage-2 step {self.steps}")
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if self.mesh is not None:
            all_reduce_grads_([t for _, t in self._named], 1.0 / self.mesh.size)
        return loss.detach(), new_state

    def adam_update(self, lr: float) -> None:
        """Adam at lr on the leaves' grads, with optax's semantics: a leaf
        without a grad takes a zero one (its moments decay), and under
        freezeBN the BN affine's grads are zero, so it stays bit-identical."""
        for name, t in self._named:
            if t.grad is None or (self.cfg.freezeBN and name.endswith(("bn_scale",
                                                                       "bn_bias"))):
                t.grad = torch.zeros_like(t)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()

    # ------------------------------------------------------------- data prep
    def prerender_train_views(self) -> np.ndarray:
        tr = self.scene.train
        return self.nerf.prerender_views(tr.poses, tr.hists)

    def rvs_refresh(self, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """Perturb every train pose and render the virtual views."""
        cfg, tr = self.cfg, self.scene.train
        poses = tr.poses
        b_min = poses[:, :3, 3].min(0) - cfg.d_max
        b_max = poses[:, :3, 3].max(0) + cfg.d_max
        perturbed = np.stack([
            perturb_single_render_pose(p, cfg.rvs_trans, cfg.rvs_rotation, rng)
            for p in poses])
        perturbed[:, :3, 3] = np.clip(perturbed[:, :3, 3], b_min, b_max)
        perturbed = perturbed.astype(np.float32)
        print("renders RVS...")
        virtual = self.nerf.prerender_views(perturbed, tr.hists, log_every=0)
        return perturbed, virtual

    # ------------------------------------------------------------- epochs
    @staticmethod
    def epoch_batches(n: int, b: int, rng: np.random.Generator):
        """Shuffled full-size index batches covering every image (the
        reference's drop_last=False): the tail batch wraps around to the
        permutation's head."""
        order = rng.permutation(n)
        pad = -n % b
        if pad:
            order = np.resize(order, n + pad)  # cyclic wrap (handles n < b)
        return [order[i:i + b] for i in range(0, len(order), b)]

    def train_epoch(self, targets, rgbs, virtue_view, poses_perturb,
                    rng: np.random.Generator) -> float:
        """One epoch; images as `epoch_images` gives them: numpy (N, H, W, 3)
        under --prefetch, else device tensors. Returns the mean step loss."""
        cfg = self.cfg
        n = len(self.scene.train)
        b = cfg.featurenet_batch_size
        lr = self.scheduler.lr
        rvs = cfg.random_view_synthesis
        if rvs:
            poses_perturb = np.asarray(poses_perturb, np.float32).reshape(n, 12)
        batches = self.epoch_batches(n, b, rng)
        if cfg.prefetch > 0:
            poses12 = self.scene.train.poses.reshape(n, 12)

            def make_batch(idx):
                return (targets[idx], rgbs[idx], poses12[idx],
                        virtue_view[idx] if rvs else None, poses_perturb[idx] if rvs else None)

            nchw = lambda t: None if t is None else t.permute(0, 3, 1, 2).contiguous()
            it = ((nchw(t), nchw(r), p, nchw(rp), pp) for t, r, p, rp, pp in
                  PrefetchIterator(make_batch, batches, depth=cfg.prefetch, device=self.device))
        else:
            targets, rgbs = self.images(targets), self.images(rgbs)
            if rvs:
                virtue_view = self.images(virtue_view)
                poses_perturb = torch.as_tensor(poses_perturb, device=self.device)

            def on_device(idx):
                i = torch.as_tensor(idx, device=self.device)
                return (targets[i], rgbs[i], self._train_poses12[i],
                        virtue_view[i] if rvs else None, poses_perturb[i] if rvs else None)

            it = (on_device(idx) for idx in batches)
        losses = [self.train_step(*batch, lr) for batch in it]
        return float(np.mean(torch.stack(losses).cpu().numpy()))

    @torch.no_grad()
    def predict(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 12) poses of (B, 3, H, W) device images: eval-mode BN, float32
        convs whatever feature_precision (the eval path of the JAX package)."""
        _, pose, _ = dfnet_forward(self.params, self.state, images, self.model_cfg,
                                   return_feature=False, train_bn=False)
        return pose

    def validate(self) -> float:
        """Val pose MSE over the whole split, in val_batch_size batches
        (eval-mode BN has no batch coupling), read back once."""
        val = self.scene.val
        if self._val_images is None:
            self._val_images = self.images(val.images)
        b = max(self.cfg.val_batch_size, 1)
        pred = torch.cat([self.predict(x) for x in self._val_images.split(b)])
        pred = pred.cpu().numpy()
        return float(np.mean((pred - val.poses.reshape(len(val), 12)) ** 2))

    def eval_median_error(self, split=None):
        split = split if split is not None else self.scene.val
        return get_error_in_q(lambda imgs: self.predict(self.images(imgs)), split)

    # ------------------------------------------------------------- persistence
    def checkpoint_tree(self) -> Dict:
        params, state = dfnet_params_to_jax(self.params, self.state)
        return {"params": params, "state": state}

    def load(self, path: str):
        """Adopt a checkpoint's params (in place, the optimizer keeps its
        state as the JAX package's does) and BN state."""
        params, state = load_dfnet_params(path, self.device)
        with torch.no_grad():
            for (_, t), (_, v) in zip(self._named, named_leaves(params)):
                t.copy_(v)
        self.net.state = state
