"""VGG16 feature encoder (port of dfnet_tpu/models/vgg.py, the VGG16 part).

torchvision's vgg16.features layer stack, which the reference uses as the
DFNet backbone with hypercolumn taps at the conv1_2 / conv3_3 / conv5_3
outputs: the raw conv outputs, PRE-ReLU.

Layout: NCHW activations, OIHW conv weights (the JAX package keeps NHWC
and HWIO; models/dfnet.py bridges the two). The convs are
torch.nn.functional.conv2d: the JAX package runs them through XLA's
convolution, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

# (name, out_channels); 'M' = 2x2 maxpool. torchvision vgg16 config "D".
VGG16_LAYOUT = [
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), "M",
]

CONV_NAMES = [e[0] for e in VGG16_LAYOUT if e != "M"]

# torch features-sequential index of each conv (conv,relu pairs + pools)
TORCH_CONV_INDEX = {}
_i = 0
for _e in VGG16_LAYOUT:
    if _e == "M":
        _i += 1
    else:
        TORCH_CONV_INDEX[_e[0]] = _i
        _i += 2

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _torch_conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
                     device="cpu") -> Dict:
    """torch.nn.Conv2d default: kaiming-uniform(a=√5) weights -> bound
    √(6/((1+5)·fan_in)) = 1/√fan_in; bias uniform with the same bound.
    Weights OIHW, drawn from `gen` on the CPU."""
    bound = 1.0 / np.sqrt(kh * kw * cin)
    w = (torch.rand((cout, cin, kh, kw), generator=gen) * 2 - 1) * bound
    b = (torch.rand((cout,), generator=gen) * 2 - 1) * bound
    return {"w": w.to(device), "b": b.to(device)}


def init_vgg16_params(gen: torch.Generator, device="cpu") -> Dict:
    params = {}
    cin = 3
    for name, cout in [e for e in VGG16_LAYOUT if e != "M"]:
        params[name] = _torch_conv_init(gen, 3, 3, cin, cout, device)
        cin = cout
    return params


def conv2d(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Stride-1 'SAME' conv of an NCHW tensor with odd square kernels."""
    return Fn.conv2d(x, p["w"], p["b"], padding=p["w"].shape[-1] // 2)


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    return Fn.max_pool2d(x, 2, 2)


def vgg16_features(params: Dict, x: torch.Tensor, taps: Sequence[str] = (),
                   run_to_end: bool = True) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """x: (B, 3, H, W), already ImageNet-normalized. Returns (final, taps)
    where taps are the PRE-ReLU conv outputs of the named layers. If
    run_to_end is False, stops after the last tap (DFNet's
    return_pose=False early exit)."""
    taps = list(taps)
    got: List[torch.Tensor] = []
    last_tap = taps[-1] if taps else None
    for entry in VGG16_LAYOUT:
        if entry == "M":
            x = maxpool2(x)
            continue
        name, _ = entry
        x = conv2d(params[name], x)
        if name in taps:
            got.append(x)
            if name == last_tap and not run_to_end:
                return x, got
        x = torch.relu(x)
    return x, got


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """x: (B, 3, H, W) RGB in [0, 1]."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=x.device)[:, None, None]
    return (x - mean) / std
