"""MobileNetV2 backbone + PoseNetV2, the reference's non-DFNet APR and
feature branch (port of dfnet_tpu/models/mobilenet.py).

PoseNetV2: torchvision mobilenet_v2 features -> global average pool ->
Linear(1280, 12); the feature tap is block 17's output, stacked single- or
two-stream. The backbone is torchvision's mobilenet_v2.features:
  [0]  ConvBNReLU6 3->32 /2
  [1..17] inverted residuals, cfg (t, c, n, s) = (1,16,1,1)(6,24,2,2)
          (6,32,3,2)(6,64,4,2)(6,96,3,1)(6,160,3,2)(6,320,1,1)
  [18] ConvBNReLU6 320->1280

NCHW with torch-layout weights (models/layers.py; params_from_jax carries
a JAX tree across); BatchNorm in float32 with its running stats in
`state` (momentum 0.1), train and eval modes. bf16 runs under autocast.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from dfnet_tpu_torch.models.layers import as_numpy, batchnorm, bn_init, conv, tree_to
from dfnet_tpu_torch.models.vgg import imagenet_normalize

BN_EPS = 1e-5
BN_MOMENTUM = 0.1

INVERTED_RESIDUAL_CFG = [
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


def _block_layers(cin: int, cout: int, t: int, stride: int) -> List[Tuple]:
    """Layer spec of one inverted residual: [(kind, k, cin, cout, stride,
    groups)] with kinds pw (expand) / dw / pwl (linear projection)."""
    hidden = cin * t
    layers = []
    if t != 1:
        layers.append(("pw", 1, cin, hidden, 1, 1))
    layers.append(("dw", 3, hidden, hidden, stride, hidden))
    layers.append(("pwl", 1, hidden, cout, 1, 1))
    return layers


def mobilenet_v2_structure():
    """[(kind, layers, use_residual)] for features[0..18]."""
    blocks = [("conv", [("pw", 3, 3, 32, 2, 1)], False)]
    cin = 32
    for t, c, n, s in INVERTED_RESIDUAL_CFG:
        for i in range(n):
            stride = s if i == 0 else 1
            blocks.append(("ir", _block_layers(cin, c, t, stride),
                           stride == 1 and cin == c))
            cin = c
    blocks.append(("conv", [("pw", 1, cin, 1280, 1, 1)], False))
    return blocks


def init_mobilenet_params(gen: torch.Generator, device="cpu") -> Tuple[Dict, Dict]:
    """(params, state): convs with torch's default kaiming-uniform(a=sqrt 5)
    init drawn from `gen`, BatchNorm at identity."""
    params: Dict = {}
    state: Dict = {}
    for bi, (_, layers, _) in enumerate(mobilenet_v2_structure()):
        bp, bs = [], []
        for (_, k, cin, cout, _, groups) in layers:
            bound = np.sqrt(6.0 / ((1 + 5) * k * k * cin // groups))
            w = (torch.rand((cout, cin // groups, k, k), generator=gen) * 2 - 1) * bound
            bn_p, bn_s = bn_init(cout)
            bp.append({"w": w, "bn": bn_p})
            bs.append({"bn": bn_s})
        params[str(bi)] = bp
        state[str(bi)] = bs
    return tree_to(params, device), tree_to(state, device)


def mobilenet_features(params: Dict, state: Dict, x: torch.Tensor,
                       train_bn: bool = False, taps=(17,)):
    """x: (B, 3, H, W) ImageNet-normalized. Returns (final (B, 1280, h, w),
    {tap index: activation}, new_state)."""
    new_state: Dict = {}
    tapped = {}
    for bi, (_, layers, residual) in enumerate(mobilenet_v2_structure()):
        inp = x
        bs_new = []
        for li, (kind, k, _, _, stride, groups) in enumerate(layers):
            p, s = params[str(bi)][li], state[str(bi)][li]
            x = conv(x, p["w"], stride=stride, groups=groups, padding=k // 2)
            x, bn_new = batchnorm(p["bn"], s["bn"], x, train_bn, BN_MOMENTUM, BN_EPS)
            bs_new.append({"bn": bn_new})
            if kind != "pwl":                       # linear bottleneck: no act
                x = torch.clamp(torch.relu(x), max=6.0)
        if residual:
            x = x + inp
        new_state[str(bi)] = bs_new
        if bi in taps:
            tapped[bi] = x
    return x, tapped, new_state


@dataclass(frozen=True)
class PoseNetV2Config:
    feat_dim: int = 12
    tap_block: int = 17


def init_posenetv2_params(gen: torch.Generator, device="cpu") -> Tuple[Dict, Dict]:
    params, state = init_mobilenet_params(gen, device)
    bound = 1.0 / np.sqrt(1280)
    w = (torch.rand((12, 1280), generator=gen) * 2 - 1) * bound
    b = (torch.rand((12,), generator=gen) * 2 - 1) * bound
    params["fc_pose"] = {"w": w.to(device), "b": b.to(device)}
    return params, state


def posenetv2_forward(params: Dict, state: Dict, x: torch.Tensor,
                      is_train: bool = False, is_single_stream: bool = False,
                      train_bn: bool = False):
    """x: (B, 3, H, W) RGB in [0, 1]. Returns (feat_out, predict (B, 12),
    new_state). feat_out is [] or a list with one (1 or 2, B', C, h, w)
    stack of block-17 features: the whole batch, or its two halves."""
    backbone = {k: v for k, v in params.items() if k != "fc_pose"}
    final, tapped, new_state = mobilenet_features(
        backbone, state, imagenet_normalize(x), train_bn, taps=(17,))
    feat_out = []
    if is_train:
        f = tapped[17]
        if is_single_stream:
            feat_out.append(f[None])
        else:
            b = f.shape[0]
            feat_out.append(torch.stack([f[: b // 2], f[b // 2:]]))
    pooled = final.float().mean((2, 3))
    return feat_out, Fn.linear(pooled, params["fc_pose"]["w"], params["fc_pose"]["b"]), new_state


def convert_mobilenet_v2(sd: Dict, device="cpu") -> Tuple[Dict, Dict]:
    """torchvision mobilenet_v2 state_dict -> (params, state) of the backbone
    (the features.* keys), as tensors on `device`. The same leaves as the
    JAX package's converter, carried across (layers.params_from_jax)."""
    sd = {k: torch.tensor(as_numpy(v), device=device) for k, v in sd.items()}

    def bn(name):
        return ({"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]},
                {"mean": sd[f"{name}.running_mean"], "var": sd[f"{name}.running_var"]})

    params: Dict = {}
    state: Dict = {}
    for bi, (kind, layers, _) in enumerate(mobilenet_v2_structure()):
        if kind == "conv":
            names = [(f"features.{bi}.0", f"features.{bi}.1")]
        else:
            n = len(layers)
            names = [(f"features.{bi}.conv.{li}.0", f"features.{bi}.conv.{li}.1")
                     for li in range(n - 1)]
            names.append((f"features.{bi}.conv.{n - 1}", f"features.{bi}.conv.{n}"))
        bp, bs = [], []
        for cname, bname in names:
            bn_p, bn_s = bn(bname)
            bp.append({"w": sd[f"{cname}.weight"], "bn": bn_p})
            bs.append({"bn": bn_s})
        params[str(bi)] = bp
        state[str(bi)] = bs
    return params, state
