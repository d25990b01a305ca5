"""VGG feature encoders (port of dfnet_tpu/models/vgg.py).

torchvision's vgg16.features layer stack, which the reference uses as the
DFNet backbone with hypercolumn taps at the conv1_2 / conv3_3 / conv5_3
outputs: the raw conv outputs, PRE-ReLU. And any VGG layout (VGG19_LAYOUT
for the autoencoder zoo) tapped POST-op at torch's `features` indices
(vgg_features_by_index).

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

# torchvision vgg19 config "E" (the autoencoder_vgg3..7 zoo's encoder)
VGG19_LAYOUT = [
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512), "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("conv5_4", 512), "M",
]

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


def torch_conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
                    device="cpu") -> Dict:
    """torch.nn.Conv2d default: kaiming-uniform(a=√5) weights -> bound
    √(6/((1+5)·fan_in)) = 1/√fan_in; bias uniform with the same bound.
    Weights OIHW, drawn from `gen` on the CPU."""
    bound = 1.0 / np.sqrt(kh * kw * cin)
    w = (torch.rand((cout, cin, kh, kw), generator=gen) * 2 - 1) * bound
    b = (torch.rand((cout,), generator=gen) * 2 - 1) * bound
    return {"w": w.to(device), "b": b.to(device)}


def init_vgg_params(gen: torch.Generator, layout, device="cpu") -> Dict:
    """Conv params for any VGG layout (16 or 19), torch's default init."""
    params = {}
    cin = 3
    for name, cout in [e for e in layout if e != "M"]:
        params[name] = torch_conv_init(gen, 3, 3, cin, cout, device)
        cin = cout
    return params


def init_vgg16_params(gen: torch.Generator, device="cpu") -> Dict:
    return init_vgg_params(gen, VGG16_LAYOUT, device)


def conv2d(p: Dict, x: torch.Tensor, stride: int = 1, padding="SAME") -> torch.Tensor:
    """Conv of an NCHW tensor with square kernels: padding 'SAME' (stride 1,
    odd kernels: k // 2 a side), 'VALID', or a symmetric int."""
    k = p["w"].shape[-1]
    if padding == "SAME":
        if stride != 1 or k % 2 == 0:
            raise ValueError("'SAME' here is stride 1 with an odd kernel")
        padding = k // 2
    elif padding == "VALID":
        padding = 0
    return Fn.conv2d(x, p["w"], p["b"], stride=stride, padding=padding)


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


def vgg_features_by_index(params: Dict, x: torch.Tensor, layout,
                          tap_indices: Sequence[int]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Run a VGG features stack, tapping POST-op outputs at the given torch
    features indices (conv, ReLU pairs, then pools: index 3 is the ReLU
    after conv1_2). Returns (final pre-classifier tensor, taps in request
    order)."""
    want = set(tap_indices)
    got = {}
    i = 0
    for entry in layout:
        if entry == "M":
            x = maxpool2(x)
            if i in want:
                got[i] = x
            i += 1
            continue
        x = conv2d(params[entry[0]], x)
        if i in want:
            got[i] = x
        x = torch.relu(x)
        if i + 1 in want:
            got[i + 1] = x
        i += 2
    return x, [got[j] for j in tap_indices]


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """x: (B, 3, H, W) RGB in [0, 1]."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=x.device)[:, None, None]
    return (x - mean) / std
