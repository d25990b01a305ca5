"""EfficientNet-B0/B3 backbones + the reference's EfficientNet APR (port of
dfnet_tpu/models/efficientnet.py).

The APR is extract_features -> global average pool -> Linear(head, 12),
with head 1280 (B0) or 1536 (B3). MBConv blocks with expansion, depthwise
conv, squeeze-excitation and SiLU; width and depth scaling with divisor-8
rounding; TF-style 'SAME' padding (asymmetric for stride 2), as
efficientnet_pytorch's Conv2dStaticSamePadding, which the reference's
backbones load.

NCHW with torch-layout weights (models/layers.py); BatchNorm in float32
(eps 1e-3, momentum 0.01) with its running stats in `state`. bf16 runs
under autocast.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from dfnet_tpu_torch.models.layers import (
    as_numpy,
    batchnorm,
    bn_init,
    conv,
    tree_to,
)
from dfnet_tpu_torch.models.vgg import imagenet_normalize

BN_EPS = 1e-3
BN_MOMENTUM = 0.01

# (expand, channels, repeats, stride, kernel): the B0 baseline
BASE_BLOCKS = [
    (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3),
]

SCALING = {"b0": (1.0, 1.0), "b3": (1.2, 1.4)}  # (width, depth)
HEAD_DIM = {"b0": 1280, "b3": 1536}


def round_filters(c: int, width: float, divisor: int = 8) -> int:
    c *= width
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return int(new_c)


def round_repeats(r: int, depth: float) -> int:
    return int(math.ceil(depth * r))


def efficientnet_structure(variant: str = "b0"):
    """(stem channels, [(kernel, cin, cout, stride, expand)] per block,
    last block's channels, head channels)."""
    width, depth = SCALING[variant]
    stem_c = round_filters(32, width)
    blocks = []
    cin = stem_c
    for expand, c, repeats, stride, k in BASE_BLOCKS:
        cout = round_filters(c, width)
        for i in range(round_repeats(repeats, depth)):
            blocks.append((k, cin, cout, stride if i == 0 else 1, expand))
            cin = cout
    head_c = round_filters(HEAD_DIM[variant], width) if variant == "b0" else HEAD_DIM[variant]
    return stem_c, blocks, cin, head_c


def _conv_init(gen: torch.Generator, k: int, cin: int, cout: int, groups: int = 1):
    """N(0, 2 / fan_out), fan_out = k * k * cout / groups; OIHW."""
    std = np.sqrt(2.0 / (k * k * cout // groups))
    return std * torch.randn((cout, cin // groups, k, k), generator=gen)


def _same_conv(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1, groups: int = 1):
    """TF-style 'SAME' padding: asymmetric, the extra row and column at the
    bottom and right, where the stride does not divide the size."""
    k = w.shape[-1]

    def same(size):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        return total // 2, total - total // 2
    return conv(x, w, b, stride, groups, tuple(same(n) for n in x.shape[-2:]))


def _bn(p, s, x, train):
    return batchnorm(p, s, x, train, BN_MOMENTUM, BN_EPS)


def init_efficientnet_params(gen: torch.Generator, variant: str = "b0",
                             device="cpu") -> Tuple[Dict, Dict]:
    """(params, state) drawn from `gen`: convs N(0, 2 / fan_out), zero SE
    biases, BatchNorm at identity."""
    stem_c, blocks, last_c, head_c = efficientnet_structure(variant)
    params: Dict = {"stem": {"w": _conv_init(gen, 3, 3, stem_c)}}
    state: Dict = {}
    params["stem"]["bn"], bs = bn_init(stem_c)
    state["stem"] = {"bn": bs}
    for bi, (k, cin, cout, stride, expand) in enumerate(blocks):
        hidden = cin * expand
        bp: Dict = {}
        bst: Dict = {}
        if expand != 1:
            bp["expand"] = {"w": _conv_init(gen, 1, cin, hidden)}
            bp["expand"]["bn"], bst["bn_e"] = bn_init(hidden)
        bp["dw"] = {"w": _conv_init(gen, k, hidden, hidden, groups=hidden)}
        bp["dw"]["bn"], bst["bn_d"] = bn_init(hidden)
        se_c = max(1, cin // 4)
        bp["se_reduce"] = {"w": _conv_init(gen, 1, hidden, se_c), "b": torch.zeros(se_c)}
        bp["se_expand"] = {"w": _conv_init(gen, 1, se_c, hidden), "b": torch.zeros(hidden)}
        bp["project"] = {"w": _conv_init(gen, 1, hidden, cout)}
        bp["project"]["bn"], bst["bn_p"] = bn_init(cout)
        params[f"block{bi}"] = bp
        state[f"block{bi}"] = bst
    params["head"] = {"w": _conv_init(gen, 1, last_c, head_c)}
    params["head"]["bn"], bs = bn_init(head_c)
    state["head"] = {"bn": bs}
    return tree_to(params, device), tree_to(state, device)


def efficientnet_features(params: Dict, state: Dict, x: torch.Tensor,
                          variant: str = "b0", train_bn: bool = False,
                          taps: Tuple[int, ...] = ()):
    """x (B, 3, H, W) normalized -> (final (B, head_c, h, w), {block: act},
    new_state)."""
    _, blocks, _, _ = efficientnet_structure(variant)
    silu = Fn.silu
    new_state: Dict = {}
    tapped: Dict = {}
    h, ns = _bn(params["stem"]["bn"], state["stem"]["bn"],
                _same_conv(x, params["stem"]["w"], stride=2), train_bn)
    new_state["stem"] = {"bn": ns}
    h = silu(h)
    for bi, (_, cin, cout, stride, expand) in enumerate(blocks):
        bp = params[f"block{bi}"]
        bs = state[f"block{bi}"]
        ns = {}
        y = h
        if expand != 1:
            y, ns["bn_e"] = _bn(bp["expand"]["bn"], bs["bn_e"],
                                _same_conv(y, bp["expand"]["w"]), train_bn)
            y = silu(y)
        y, ns["bn_d"] = _bn(bp["dw"]["bn"], bs["bn_d"],
                            _same_conv(y, bp["dw"]["w"], stride=stride, groups=y.shape[1]),
                            train_bn)
        y = silu(y)
        # squeeze-excitation
        se = y.mean((2, 3), keepdim=True)
        se = silu(_same_conv(se, bp["se_reduce"]["w"], bp["se_reduce"]["b"]))
        se = torch.sigmoid(_same_conv(se, bp["se_expand"]["w"], bp["se_expand"]["b"]))
        y, ns["bn_p"] = _bn(bp["project"]["bn"], bs["bn_p"],
                            _same_conv(y * se, bp["project"]["w"]), train_bn)
        if stride == 1 and cin == cout:
            y = y + h
        h = y
        new_state[f"block{bi}"] = ns
        if bi in taps:
            tapped[bi] = h
    h, ns = _bn(params["head"]["bn"], state["head"]["bn"],
                _same_conv(h, params["head"]["w"]), train_bn)
    new_state["head"] = {"bn": ns}
    return silu(h), tapped, new_state


@dataclass(frozen=True)
class EfficientNetAPRConfig:
    variant: str = "b3"
    feat_dim: int = 12


def init_efficientnet_apr(gen: torch.Generator,
                          cfg: EfficientNetAPRConfig = EfficientNetAPRConfig(),
                          device="cpu") -> Tuple[Dict, Dict]:
    params, state = init_efficientnet_params(gen, cfg.variant, device)
    head_c = HEAD_DIM[cfg.variant]
    bound = 1.0 / np.sqrt(head_c)
    w = (torch.rand((cfg.feat_dim, head_c), generator=gen) * 2 - 1) * bound
    b = (torch.rand((cfg.feat_dim,), generator=gen) * 2 - 1) * bound
    params["fc_pose"] = {"w": w.to(device), "b": b.to(device)}
    return params, state


def efficientnet_apr_forward(params: Dict, state: Dict, x: torch.Tensor,
                             cfg: EfficientNetAPRConfig = EfficientNetAPRConfig(),
                             train_bn: bool = False):
    """The EfficientNet APR: x (B, 3, H, W) RGB in [0, 1] -> features ->
    average pool -> fc pose (B, 12); returns (pose, new_state)."""
    backbone = {k: v for k, v in params.items() if k != "fc_pose"}
    final, _, new_state = efficientnet_features(
        backbone, state, imagenet_normalize(x), cfg.variant, train_bn)
    pooled = final.float().mean((2, 3))
    return Fn.linear(pooled, params["fc_pose"]["w"], params["fc_pose"]["b"]), new_state


def convert_efficientnet(sd: Dict, variant: str = "b3", device="cpu") -> Tuple[Dict, Dict]:
    """lukemelas efficientnet_pytorch state_dict -> (params, state) as
    tensors on `device`; keys _conv_stem/_bn0, _blocks.{i}.{_expand_conv,
    _bn0, _depthwise_conv, _bn1, _se_reduce, _se_expand, _project_conv,
    _bn2}, _conv_head/_bn1. The same leaves as the JAX package's
    converter, carried across (layers.params_from_jax)."""
    sd = {k: torch.tensor(as_numpy(v), device=device) for k, v in sd.items()}

    def conv_w(name):
        return {"w": sd[f"{name}.weight"]}

    def bn(name):
        return ({"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]},
                {"mean": sd[f"{name}.running_mean"], "var": sd[f"{name}.running_var"]})

    _, blocks, _, _ = efficientnet_structure(variant)
    params = {"stem": conv_w("_conv_stem")}
    state = {}
    params["stem"]["bn"], s0 = bn("_bn0")
    state["stem"] = {"bn": s0}
    for bi, (_, _, _, _, expand) in enumerate(blocks):
        base = f"_blocks.{bi}"
        bp, bst = {}, {}
        if expand != 1:
            bp["expand"] = conv_w(f"{base}._expand_conv")
            bp["expand"]["bn"], bst["bn_e"] = bn(f"{base}._bn0")
        bp["dw"] = conv_w(f"{base}._depthwise_conv")
        bp["dw"]["bn"], bst["bn_d"] = bn(f"{base}._bn1")
        for se in ("_se_reduce", "_se_expand"):
            bp[se[1:]] = {"w": sd[f"{base}.{se}.weight"], "b": sd[f"{base}.{se}.bias"]}
        bp["project"] = conv_w(f"{base}._project_conv")
        bp["project"]["bn"], bst["bn_p"] = bn(f"{base}._bn2")
        params[f"block{bi}"] = bp
        state[f"block{bi}"] = bst
    params["head"] = conv_w("_conv_head")
    params["head"]["bn"], s1 = bn("_bn1")
    state["head"] = {"bn": s1}
    return params, state
