"""DFNet — siamese pose regressor + domain-invariant feature extractor
(port of dfnet_tpu/models/dfnet.py, with the same param names).

  - VGG16 encoder with hypercolumn taps at conv1_2/conv3_3/conv5_3
    (DFNet) or conv1_2 only (DFNet_s), taps taken PRE-ReLU;
  - per-level adaptation: 1x1 conv -> ReLU -> 5x5 conv -> BatchNorm;
  - features bilinearly upsampled (align_corners=True) to a common
    (upsample_h, upsample_w) and stacked per level; siamese calls split
    the batch halves into (target, rendered) stacks;
  - pose head: global average pool of the pool5 output -> Linear(512, 12);
  - ImageNet normalization happens inside the model.

Layout: NCHW images, OIHW conv weights, fc_pose.w (12, 512) as
torch.nn.Linear stores it. Features are returned as (L, B, C, H, W); the
JAX package returns (L, B, H, W, C), and training/feature_losses.py maps
its reduction axes. BatchNorm running statistics live in a separate
`state` tree with the JAX package's names; `dfnet_params_from_jax` and
`dfnet_params_to_jax` carry both trees across.

Precision: compute_dtype=bfloat16 casts the input and the encoder weights
explicitly (no autocast); the adapt convs take the feature's dtype and the
feature maps leave in bf16. BatchNorm statistics, pooling and the pose
head run in float32 either way. A float32 forward runs its convs in IEEE
float32, without cuDNN (`conv_precision`).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as Fn

from dfnet_tpu_torch.models.layers import params_from_jax, params_to_jax
from dfnet_tpu_torch.models.vgg import (
    VGG16_LAYOUT,
    torch_conv_init,
    conv2d,
    imagenet_normalize,
    init_vgg16_params,
    vgg16_features,
)
from dfnet_tpu_torch.ops.resize import resize_bilinear_nchw

_VGG_CHANNELS = {name: c for name, c in [e for e in VGG16_LAYOUT if e != "M"]}

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


@dataclass(frozen=True)
class DFNetConfig:
    hypercolumn_layers: Tuple[str, ...] = ("conv1_2", "conv3_3", "conv5_3")
    output_dim: int = 128
    feat_dim: int = 12          # 3x4 pose

    @classmethod
    def small(cls) -> "DFNetConfig":
        """DFNet_s — conv1_2 tap only."""
        return cls(hypercolumn_layers=("conv1_2",))


def init_dfnet_params(gen: torch.Generator, cfg: DFNetConfig = DFNetConfig(),
                      device="cpu") -> Tuple[Dict, Dict]:
    """Returns (params, state), torch's default inits drawn from `gen`.
    state holds the BN running mean/var."""
    params: Dict = {"encoder": init_vgg16_params(gen, device), "adapt": {}}
    state: Dict = {"adapt": {}}
    for i, name in enumerate(cfg.hypercolumn_layers):
        params["adapt"][str(i)] = {
            "conv1": torch_conv_init(gen, 1, 1, _VGG_CHANNELS[name], 64, device),
            "conv2": torch_conv_init(gen, 5, 5, 64, cfg.output_dim, device),
            "bn_scale": torch.ones(cfg.output_dim, device=device),
            "bn_bias": torch.zeros(cfg.output_dim, device=device),
        }
        state["adapt"][str(i)] = {
            "mean": torch.zeros(cfg.output_dim, device=device),
            "var": torch.ones(cfg.output_dim, device=device),
        }
    bound = 1.0 / np.sqrt(512)
    w = (torch.rand((cfg.feat_dim, 512), generator=gen) * 2 - 1) * bound
    b = (torch.rand((cfg.feat_dim,), generator=gen) * 2 - 1) * bound
    params["fc_pose"] = {"w": w.to(device), "b": b.to(device)}
    return params, state


@contextlib.contextmanager
def conv_precision(dtype: torch.dtype):
    """Inside the block, for a float32 DFNet, convolutions and matmuls in
    IEEE float32, forward and (when it runs inside) backward, without cuDNN;
    nothing for bf16. PyTorch's defaults let cuDNN convs and matmuls use
    TF32, so matmuls' TF32 is off and cuDNN is off: on an H100 its float32
    weight-gradient algorithm for the 5x5 adapt conv misses the CPU's by
    more than the golden stage-2 bar where PyTorch's own convolution
    (im2col and a float32 GEMM) does not, and its no-grad forward (predict,
    validate) is the slower of the two (scripts/feature_diag.py, "validate")."""
    if dtype != torch.float32:
        yield
        return
    prev = torch.backends.cudnn.enabled, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.enabled = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled, torch.backends.cuda.matmul.allow_tf32 = prev


def _cast(p: Dict, dtype: torch.dtype) -> Dict:
    return {k: v.to(dtype) for k, v in p.items()}


def _batchnorm(p: Dict, s: Dict, x: torch.Tensor, train: bool):
    """(B, C, H, W) BatchNorm2d in float32. Train mode normalises by the
    batch mean and biased variance and returns new running stats
    (momentum 0.1, unbiased variance); eval mode uses the running stats."""
    x = x.float()
    if train:
        mean, var = s["mean"].clone(), s["var"].clone()
        y = Fn.batch_norm(x, mean, var, p["bn_scale"], p["bn_bias"], training=True,
                          momentum=BN_MOMENTUM, eps=BN_EPS)
        return y, {"mean": mean, "var": var}
    y = Fn.batch_norm(x, s["mean"], s["var"], p["bn_scale"], p["bn_bias"],
                      training=False, eps=BN_EPS)
    return y, s


def _adapt_level(p: Dict, s: Dict, f: torch.Tensor, train_bn: bool):
    conv1, conv2 = p["conv1"], p["conv2"]
    if f.dtype != torch.float32:
        conv1, conv2 = _cast(conv1, f.dtype), _cast(conv2, f.dtype)
    h = torch.relu(conv2d(conv1, f))
    return _batchnorm(p, s, conv2d(conv2, h), train_bn)


def dfnet_encode(params: Dict, x: torch.Tensor, cfg: DFNetConfig = DFNetConfig(),
                 return_pose: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
    """The encoder half of dfnet_forward: (pooled, taps) of (B, 3, H, W)
    RGB in [0, 1]. taps: the hypercolumn taps (pre-ReLU, compute_dtype),
    one (B, C, h, w) each; pooled: the pool5 output's global average,
    (B, 512) float32, or None when return_pose=False (the encoder then
    stops at the last tap). Per image: a data mesh splits this half by
    images (training/feature_trainer.py)."""
    with conv_precision(compute_dtype):
        x = imagenet_normalize(x)
        enc = params["encoder"]
        if compute_dtype != torch.float32:
            x = x.to(compute_dtype)
            enc = {k: _cast(v, compute_dtype) for k, v in enc.items()}
        final, taps = vgg16_features(enc, x, cfg.hypercolumn_layers,
                                     run_to_end=return_pose)
        return (final.float().mean((2, 3)) if return_pose else None), taps


def dfnet_head(params: Dict, state: Dict, pooled, taps, cfg: DFNetConfig = DFNetConfig(),
               return_feature: bool = False, is_single_stream: bool = False,
               upsample_h: int = 240, upsample_w: int = 427, train_bn: bool = False,
               compute_dtype: torch.dtype = torch.float32,
               feature_count: int | None = None):
    """The rest of dfnet_forward on dfnet_encode's (pooled, taps): the
    adapt branch (1x1 conv, ReLU, 5x5 conv, BatchNorm over the batch), the
    upsample and the pose head. Returns (feature_maps, pose, new_state) as
    dfnet_forward does (pose None when pooled is None)."""
    with conv_precision(compute_dtype):
        feature_maps = None
        new_state = state
        if return_feature:
            fc = taps[0].shape[0] if feature_count is None else feature_count
            ups, new_adapt = [], {}
            for i, f in enumerate(taps):
                a, new_adapt[str(i)] = _adapt_level(params["adapt"][str(i)],
                                                    state["adapt"][str(i)], f[:fc],
                                                    train_bn)
                ups.append(resize_bilinear_nchw(a.to(compute_dtype), upsample_h,
                                                upsample_w))
            new_state = {**state, "adapt": new_adapt}
            if is_single_stream:
                feature_maps = (torch.stack(ups),)                 # (L, B, C, H, W)
            else:
                h = ups[0].shape[0] // 2
                feature_maps = (torch.stack([u[:h] for u in ups]),
                                torch.stack([u[h:] for u in ups]))
        if pooled is None:
            return feature_maps, None, new_state
        pose = Fn.linear(pooled, params["fc_pose"]["w"], params["fc_pose"]["b"])
        return feature_maps, pose, new_state


def dfnet_forward(
    params: Dict,
    state: Dict,
    x: torch.Tensor,                # (B or 2B, 3, H, W) RGB in [0, 1]
    cfg: DFNetConfig = DFNetConfig(),
    return_feature: bool = False,
    is_single_stream: bool = False,
    return_pose: bool = True,
    upsample_h: int = 240,
    upsample_w: int = 427,
    train_bn: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    feature_count: int | None = None,
):
    """Returns (feature_maps, pose, new_state), as the JAX package's.

    feature_maps: None, or (single,) with single (L, B, C, H, W), or
    (target_stack, render_stack) for siamese input [targets; renders].
    pose: (B, feat_dim) float32, or None when return_pose=False.

    feature_count: only the first `feature_count` images flow through the
    adapt/upsample branch and its BN statistics (default: all), so pose-only
    images (stage 2's RVS views) can ride the same encoder batch.

    dfnet_encode then dfnet_head."""
    pooled, taps = dfnet_encode(params, x, cfg, return_pose, compute_dtype)
    return dfnet_head(params, state, pooled, taps, cfg, return_feature, is_single_stream,
                      upsample_h, upsample_w, train_bn, compute_dtype, feature_count)


class _ParamTree(nn.Module):
    """A nested dict of tensors as registered nn.Parameters, one submodule
    a subtree, so state_dict keys are the tree's paths joined by '.'."""

    def __init__(self, tree: Dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v.detach().float().clone()))

    def tree(self) -> Dict:
        out = {k: m.tree() for k, m in self._modules.items()}
        out.update(self._parameters)
        return out


class DFNet(nn.Module):
    """DFNet over a (params, state) pair: the params are this module's
    Parameters (`params` returns them as the tree dfnet_forward takes);
    the BN running statistics stay the plain `state` tree, replaced by
    every train-mode BN forward."""

    def __init__(self, params: Dict, state: Dict, cfg: DFNetConfig = DFNetConfig()):
        super().__init__()
        self.cfg = cfg
        self.tree = _ParamTree(params)
        self.state = state

    @property
    def params(self) -> Dict:
        return self.tree.tree()

    def forward(self, x: torch.Tensor, **kw):
        """(feature_maps, pose) of dfnet_forward(**kw) on this module's
        params and state."""
        feats, pose, self.state = dfnet_forward(self.params, self.state, x, self.cfg, **kw)
        return feats, pose


# ---------------------------------------------------------------------------
# weight bridge: the JAX package's trees (HWIO convs, fc_pose.w (512, 12))
# ---------------------------------------------------------------------------

def dfnet_params_from_jax(params: Dict, state: Dict, device="cpu") -> Tuple[Dict, Dict]:
    """The JAX package's DFNet (params, state) trees -> the port's, as
    tensors on `device`: conv w HWIO -> OIHW, fc_pose.w transposed, every
    other leaf (biases, bn_scale/bn_bias, running mean/var) as it is."""
    return params_from_jax(params, device), params_from_jax(state, device)


def dfnet_params_to_jax(params: Dict, state: Dict) -> Tuple[Dict, Dict]:
    """Inverse of dfnet_params_from_jax: numpy trees in the JAX package's
    layout (the checkpoint format both packages read)."""
    return params_to_jax(params), params_to_jax(state)
