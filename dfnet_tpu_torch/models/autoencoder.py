"""Convolutional autoencoders, the reference's early feature-extraction
experiment line (port of dfnet_tpu/models/autoencoder.py).

  - ConvAutoencoderConfig / autoencoder_forward: a VGG-style encoder
    (conv-ReLU x2 + pool a level) and a mirrored upsample + conv decoder
    that reconstructs the input; its bottleneck doubles as features;
  - autoencoder_vgg1..7: the reference's zoo (feature/model.py:45-390).
    vgg1/2 are strided-conv and transposed-conv stacks; vgg3..7 run the
    VGG19 encoder (models/vgg.py::VGG19_LAYOUT) with post-ReLU taps and
    decode with transposed convs (vgg3) or conv + bilinear upsample to
    each tap (vgg4..6); vgg6/7 return channel-mean feature maps.

NCHW with torch-layout weights: convs OIHW, transposed convs (cin, cout,
kh, kw) as torch.nn.ConvTranspose2d stores them (models/layers.py carries
a JAX tree across). The bilinear upsample is ops/resize.py's
align_corners=True one, the JAX package's formulation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from dfnet_tpu_torch.models.vgg import (
    VGG19_LAYOUT,
    torch_conv_init,
    conv2d,
    init_vgg_params,
    maxpool2,
    vgg_features_by_index,
)
from dfnet_tpu_torch.ops.resize import resize_bilinear_nchw


@dataclass(frozen=True)
class ConvAutoencoderConfig:
    widths: Tuple[int, ...] = (32, 64, 128)   # encoder level widths


def init_autoencoder_params(gen: torch.Generator,
                            cfg: ConvAutoencoderConfig = ConvAutoencoderConfig(),
                            device="cpu") -> Dict:
    enc: List[Dict] = []
    cin = 3
    for w in cfg.widths:
        enc.append({"conv1": torch_conv_init(gen, 3, 3, cin, w, device),
                    "conv2": torch_conv_init(gen, 3, 3, w, w, device)})
        cin = w
    dec: List[Dict] = []
    for w in list(reversed(cfg.widths[:-1])) + [3]:
        dec.append({"conv": torch_conv_init(gen, 3, 3, cin, w, device)})
        cin = w
    return {"enc": enc, "dec": dec}


def autoencoder_forward(params: Dict, x: torch.Tensor, return_features: bool = False):
    """x: (B, 3, H, W) -> the sigmoid reconstruction (B, 3, H, W), and with
    return_features the bottleneck features too."""
    h = x
    for level in params["enc"]:
        h = torch.relu(conv2d(level["conv1"], h))
        h = torch.relu(conv2d(level["conv2"], h))
        h = maxpool2(h)
    features = h
    for i, level in enumerate(params["dec"]):
        h = conv2d(level["conv"], resize_bilinear_nchw(h, 2 * h.shape[2], 2 * h.shape[3]))
        if i < len(params["dec"]) - 1:
            h = torch.relu(h)
    recon = torch.sigmoid(h)
    return (recon, features) if return_features else recon


# ---------------------------------------------------------------------------
# the autoencoder_vgg1..7 zoo
# ---------------------------------------------------------------------------

def _torch_convT_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
                      device="cpu") -> Dict:
    """torch.nn.ConvTranspose2d's default init: weight (cin, cout, kh, kw),
    fan_in = cout * kh * kw (torch's convention for that layout), bound
    1/sqrt(fan_in) on the weights and the bias."""
    bound = 1.0 / np.sqrt(kh * kw * cout)
    w = (torch.rand((cin, cout, kh, kw), generator=gen) * 2 - 1) * bound
    b = (torch.rand((cout,), generator=gen) * 2 - 1) * bound
    return {"w": w.to(device), "b": b.to(device)}


def conv2d_transpose(p: Dict, x: torch.Tensor, stride: int = 1, padding: int = 0,
                     output_padding: int = 0) -> torch.Tensor:
    """torch.nn.ConvTranspose2d: out = (in - 1) * stride - 2 * padding + k
    + output_padding."""
    return Fn.conv_transpose2d(x, p["w"], p["b"], stride, padding, output_padding)


def init_autoencoder_vgg1(gen: torch.Generator, device="cpu") -> Dict:
    return {
        "e1": torch_conv_init(gen, 3, 3, 3, 16, device),
        "e2": torch_conv_init(gen, 3, 3, 16, 32, device),
        "e3": torch_conv_init(gen, 7, 7, 32, 64, device),
        "d1": _torch_convT_init(gen, 7, 7, 64, 32, device),
        "d2": _torch_convT_init(gen, 3, 3, 32, 16, device),
        "d3": _torch_convT_init(gen, 3, 3, 16, 3, device),
    }


def _vgg12_encoder(params: Dict, x: torch.Tensor):
    f1 = torch.relu(conv2d(params["e1"], x, stride=2, padding=1))
    f2 = torch.relu(conv2d(params["e2"], f1, stride=2, padding=1))
    return f1, f2, conv2d(params["e3"], f2, padding="VALID")


def autoencoder_vgg1(params: Dict, x: torch.Tensor):
    """(B, 3, H, W) in [-1, 1] -> (encoding, tanh reconstruction)."""
    _, _, enc = _vgg12_encoder(params, x)
    d = torch.relu(conv2d_transpose(params["d1"], enc))
    d = torch.relu(conv2d_transpose(params["d2"], d, 2, 1, 1))
    return enc, torch.tanh(conv2d_transpose(params["d3"], d, 2, 1, 1))


init_autoencoder_vgg2 = init_autoencoder_vgg1


def autoencoder_vgg2(params: Dict, x: torch.Tensor):
    """vgg1 with encoder -> decoder skip adds; returns (None, recon)."""
    f1, f2, h = _vgg12_encoder(params, x)
    h = torch.relu(conv2d_transpose(params["d1"], h)) + f2
    h = torch.relu(conv2d_transpose(params["d2"], h, 2, 1, 1)) + f1
    return None, torch.tanh(conv2d_transpose(params["d3"], h, 2, 1, 1))


def init_autoencoder_vgg3(gen: torch.Generator, device="cpu") -> Dict:
    return {
        "encoder": init_vgg_params(gen, VGG19_LAYOUT, device),
        "d1": _torch_convT_init(gen, 2, 2, 512, 512, device),
        "d2": _torch_convT_init(gen, 4, 4, 512, 256, device),
        "d3": _torch_convT_init(gen, 4, 4, 256, 64, device),
        "d4": torch_conv_init(gen, 3, 3, 64, 3, device),
    }


def autoencoder_vgg3(params: Dict, x: torch.Tensor):
    """VGG19 encoder + transposed-conv decoder with skip adds of the
    ReLU-36 / ReLU-18 / ReLU-4 taps; the input's sides must be multiples
    of 32. Returns (feat_out, tanh recon)."""
    h, (t3, t17, t35) = vgg_features_by_index(params["encoder"], x, VGG19_LAYOUT,
                                              (3, 17, 35))
    feat_out = []
    for name, stride, tap in (("d1", 2, t35), ("d2", 4, t17), ("d3", 4, t3)):
        h = torch.relu(conv2d_transpose(params[name], h, stride=stride)) + tap
        feat_out.append(h)
    return feat_out, torch.tanh(conv2d(params["d4"], h))


def _conv_decoder_params(gen: torch.Generator, widths, device) -> List[Dict]:
    return [{"conv": torch_conv_init(gen, 3, 3, cin, cout, device)}
            for cin, cout in zip(widths[:-1], widths[1:])]


def init_autoencoder_vgg4(gen: torch.Generator, device="cpu") -> Dict:
    return {"encoder": init_vgg_params(gen, VGG19_LAYOUT, device),
            "decoder": _conv_decoder_params(gen, (512, 512, 256, 64, 3), device)}


def _up_add(dec: Dict, h: torch.Tensor, tap: torch.Tensor) -> torch.Tensor:
    """ReLU(conv(h)), bilinearly upsampled to the tap's size, plus the tap."""
    h = torch.relu(conv2d(dec["conv"], h))
    return resize_bilinear_nchw(h, tap.shape[2], tap.shape[3]) + tap


def autoencoder_vgg4(params: Dict, x: torch.Tensor):
    """VGG19 encoder + conv decoder with upsample-to-tap skip adds.
    Returns (feat_out, sigmoid recon)."""
    h, taps = vgg_features_by_index(params["encoder"], x, VGG19_LAYOUT, (3, 17, 35))
    dec = params["decoder"]
    feat_out = []
    for d, tap in zip(dec, taps[::-1]):
        h = _up_add(d, h, tap)
        feat_out.append(h)
    return feat_out, torch.sigmoid(conv2d(dec[3]["conv"], h))


def init_autoencoder_vgg5(gen: torch.Generator, device="cpu") -> Dict:
    return {"encoder": init_vgg_params(gen, VGG19_LAYOUT, device),
            "decoder": _conv_decoder_params(gen, (512, 512, 512, 256, 128, 64, 3), device)}


def _vgg5_core(params: Dict, x: torch.Tensor, pool_mean=None):
    """The vgg5/vgg6 body: a 5-tap VGG19 encoder, a 5-level conv decoder
    with upsample-to-tap skip adds; feat_out holds the three finest levels
    (channel-mean-pooled and upsampled in vgg6)."""
    h, taps = vgg_features_by_index(params["encoder"], x, VGG19_LAYOUT, (3, 8, 17, 26, 35))
    dec = params["decoder"]
    feat_out = []
    for d, tap in enumerate(taps[::-1]):
        h = _up_add(dec[d], h, tap)
        if d >= 2:
            feat_out.append(pool_mean(h) if pool_mean else h)
    return feat_out, h, dec


def autoencoder_vgg5(params: Dict, x: torch.Tensor):
    """Returns (feat_out, sigmoid recon)."""
    feat_out, h, dec = _vgg5_core(params, x)
    return feat_out, torch.sigmoid(conv2d(dec[5]["conv"], h))


def init_autoencoder_vgg6(gen: torch.Generator, device="cpu") -> Dict:
    return {"encoder": init_vgg_params(gen, VGG19_LAYOUT, device),
            "decoder": _conv_decoder_params(gen, (512, 512, 512, 256, 128, 64), device)}


def autoencoder_vgg6(params: Dict, x: torch.Tensor, upsampleH: int, upsampleW: int):
    """The robust-feature variant: each decoder feature is bilinearly
    upsampled to (upsampleH, upsampleW) and channel-mean-pooled to
    (B, upsampleH, upsampleW). Returns (feat_out, last decoder level)."""
    def pool(h):
        return resize_bilinear_nchw(h, upsampleH, upsampleW).mean(1)

    feat_out, h, _ = _vgg5_core(params, x, pool_mean=pool)
    return feat_out, h


def init_autoencoder_vgg7(gen: torch.Generator, device="cpu") -> Dict:
    return {"encoder": init_vgg_params(gen, VGG19_LAYOUT, device)}


def autoencoder_vgg7(params: Dict, x: torch.Tensor, upsampleH: int = 224,
                     upsampleW: int = 224):
    """Encoder only: the channel means of the ReLU-4 / ReLU-9 / ReLU-18 taps
    upsampled to a common size. Returns (feat_out, the encoder's output)."""
    h, taps = vgg_features_by_index(params["encoder"], x, VGG19_LAYOUT, (3, 8, 17))
    return [resize_bilinear_nchw(t, upsampleH, upsampleW).mean(1) for t in taps], h
