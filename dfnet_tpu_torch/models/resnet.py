"""ResNet34 backbone + the legacy APR heads: PoseNet_res34, the
MapNet-style PoseNet and the MapNet sequence wrapper (port of
dfnet_tpu/models/resnet.py).

torchvision resnet34 with its fc replaced by Linear(512, feat_dim), ReLU
and dropout, then a 12-dim pose head (PoseNet_res34) or split xyz /
log-quaternion heads (MapNet-style PoseNet); MapNet flattens an
(N, T, 3, H, W) sequence through the base model.

NCHW with torch-layout weights (models/layers.py); BatchNorm in float32
(momentum 0.1) with its running stats in `state`. Dropout draws its mask
from an explicit torch.Generator, so it cannot draw the JAX package's
mask: the two are compared with dropout off. bf16 runs under autocast.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from dfnet_tpu_torch.models.layers import batchnorm, bn_init, conv, tree_to
from dfnet_tpu_torch.models.vgg import imagenet_normalize

BN_EPS = 1e-5
BN_MOMENTUM = 0.1

# resnet34 layout: (blocks, channels, first stride) per stage
RESNET34_STAGES = [(3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)]


def _kaiming_normal(gen: torch.Generator, k: int, cin: int, cout: int) -> torch.Tensor:
    """N(0, 2 / fan_out), fan_out = k * k * cout; OIHW."""
    return np.sqrt(2.0 / (k * k * cout)) * torch.randn((cout, cin, k, k), generator=gen)


def _bn(p, s, x, train):
    return batchnorm(p, s, x, train, BN_MOMENTUM, BN_EPS)


def _conv(x, w, stride=1):
    return conv(x, w, stride=stride, padding=w.shape[-1] // 2)


def init_resnet34_params(gen: torch.Generator, device="cpu") -> Tuple[Dict, Dict]:
    """(params, state) drawn from `gen`: convs Kaiming normal (fan_out),
    BatchNorm at identity."""
    params: Dict = {"stem": {"w": _kaiming_normal(gen, 7, 3, 64)}}
    params["stem"]["bn"], bn_s = bn_init(64)
    state: Dict = {"stem": {"bn": bn_s}}
    cin = 64
    for si, (n_blocks, c, stride) in enumerate(RESNET34_STAGES):
        for bi in range(n_blocks):
            s = stride if bi == 0 else 1
            name = f"layer{si + 1}_{bi}"
            c_in = cin if bi == 0 else c
            bp: Dict = {"conv1": {"w": _kaiming_normal(gen, 3, c_in, c)},
                        "conv2": {"w": _kaiming_normal(gen, 3, c, c)}}
            bs: Dict = {}
            bp["conv1"]["bn"], bs["bn1"] = bn_init(c)
            bp["conv2"]["bn"], bs["bn2"] = bn_init(c)
            if s != 1 or c_in != c:
                bp["down"] = {"w": _kaiming_normal(gen, 1, c_in, c)}
                bp["down"]["bn"], bs["bn_down"] = bn_init(c)
            params[name] = bp
            state[name] = bs
        cin = c
    return tree_to(params, device), tree_to(state, device)


def resnet34_features(params: Dict, state: Dict, x: torch.Tensor, train_bn: bool = False):
    """x: (B, 3, H, W) normalized -> (pooled (B, 512), new_state)."""
    new_state: Dict = {}
    h, ns = _bn(params["stem"]["bn"], state["stem"]["bn"],
                _conv(x, params["stem"]["w"], stride=2), train_bn)
    new_state["stem"] = {"bn": ns}
    h = Fn.max_pool2d(torch.relu(h), 3, 2, 1)
    for si, (n_blocks, _, stride) in enumerate(RESNET34_STAGES):
        for bi in range(n_blocks):
            s = stride if bi == 0 else 1
            name = f"layer{si + 1}_{bi}"
            bp, bs = params[name], state[name]
            ns: Dict = {}
            y, ns["bn1"] = _bn(bp["conv1"]["bn"], bs["bn1"], _conv(h, bp["conv1"]["w"], s),
                               train_bn)
            y, ns["bn2"] = _bn(bp["conv2"]["bn"], bs["bn2"],
                               _conv(torch.relu(y), bp["conv2"]["w"]), train_bn)
            identity = h
            if "down" in bp:
                identity, ns["bn_down"] = _bn(bp["down"]["bn"], bs["bn_down"],
                                              _conv(h, bp["down"]["w"], s), train_bn)
            h = torch.relu(y + identity)
            new_state[name] = ns
    return h.float().mean((2, 3)), new_state


@dataclass(frozen=True)
class LegacyPoseNetConfig:
    feat_dim: int = 2048
    droprate: float = 0.5
    mapnet_heads: bool = False   # True: split fc_xyz / fc_wpqr (6-dim out)


def init_legacy_posenet(gen: torch.Generator,
                        cfg: LegacyPoseNetConfig = LegacyPoseNetConfig(),
                        device="cpu") -> Tuple[Dict, Dict]:
    """The ResNet34 backbone, then Linear heads (out, in) with Kaiming
    normal weights (fan_in) and zero biases."""
    params, state = init_resnet34_params(gen, device)

    def lin(fin, fout):
        w = np.sqrt(2.0 / fin) * torch.randn((fout, fin), generator=gen)
        return {"w": w.to(device), "b": torch.zeros(fout, device=device)}

    params["fc_feat"] = lin(512, cfg.feat_dim)
    if cfg.mapnet_heads:
        params["fc_xyz"] = lin(cfg.feat_dim, 3)
        params["fc_wpqr"] = lin(cfg.feat_dim, 3)
    else:
        params["fc_pose"] = lin(cfg.feat_dim, 12)
    return params, state


def _linear(p, x):
    return Fn.linear(x, p["w"], p["b"])


def legacy_posenet_forward(params: Dict, state: Dict, x: torch.Tensor,
                           cfg: LegacyPoseNetConfig,
                           gen: Optional[torch.Generator] = None, train: bool = False):
    """PoseNet_res34 / MapNet-style PoseNet. x: (B, 3, H, W) RGB in [0, 1]
    -> ((B, 12) or (B, 6), new_state). In train mode with a generator and
    droprate > 0, dropout keeps each feature with 1 - droprate and scales
    the kept ones by 1 / (1 - droprate); BatchNorm trains with `train`."""
    backbone = {k: v for k, v in params.items() if not k.startswith("fc")}
    feat, new_state = resnet34_features(backbone, state, imagenet_normalize(x), train)
    h = torch.relu(_linear(params["fc_feat"], feat))
    if train and cfg.droprate > 0 and gen is not None:
        keep = 1.0 - cfg.droprate
        mask = torch.rand(h.shape, generator=gen, device=h.device) < keep
        h = torch.where(mask, h / keep, torch.zeros_like(h))
    if cfg.mapnet_heads:
        return torch.cat([_linear(params["fc_xyz"], h), _linear(params["fc_wpqr"], h)],
                         -1), new_state
    return _linear(params["fc_pose"], h), new_state


def mapnet_forward(params: Dict, state: Dict, x_seq: torch.Tensor, cfg: LegacyPoseNetConfig,
                   gen: Optional[torch.Generator] = None, train: bool = False):
    """MapNet sequence wrapper: (N, T, 3, H, W) -> ((N, T, out_dim), new_state)."""
    n, t = x_seq.shape[:2]
    poses, new_state = legacy_posenet_forward(
        params, state, x_seq.reshape((n * t,) + x_seq.shape[2:]), cfg, gen, train)
    return poses.reshape(n, t, -1), new_state
