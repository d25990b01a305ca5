"""Layers and weight layouts shared by the port's CNNs (DFNet and the
backbone zoo: models/mobilenet.py, efficientnet.py, resnet.py,
autoencoder.py).

The port's CNNs run NCHW with torch-layout weights: convs OIHW, a
transposed conv (cin, cout, kh, kw) as torch.nn.ConvTranspose2d stores it,
a Linear (out, in). The JAX package keeps NHWC with HWIO convs, HWOI
transposed convs and (in, out) Linears; `params_from_jax` and
`params_to_jax` carry a tree across, leaf for leaf under the same names.
The zoo's BatchNorm params are {'scale', 'bias'} and its running
statistics {'mean', 'var'} sit in a separate `state` tree, as in the JAX
package.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as Fn


def as_numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def relayout(tree, conv_axes, leaf):
    """Map a tree (dicts and lists) leaf by leaf; the `w` of a layer is
    transposed (conv_axes for a 4-D weight, .T for a 2-D one)."""
    if isinstance(tree, (list, tuple)):
        return [relayout(v, conv_axes, leaf) for v in tree]
    if not isinstance(tree, dict):
        return leaf(as_numpy(tree))
    out = {k: relayout(v, conv_axes, leaf) for k, v in tree.items() if k != "w"}
    if "w" in tree:
        w = as_numpy(tree["w"])
        out["w"] = leaf(np.ascontiguousarray(np.transpose(w, conv_axes) if w.ndim == 4
                                             else w.T))
    return out


def tree_to(tree, device):
    """The same tree (dicts and lists) with every tensor moved to `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def params_from_jax(tree, device="cpu"):
    """A JAX-layout tree (numpy or JAX arrays) -> the port's layout, as
    tensors on `device`: 4-D w HWIO -> OIHW (a transposed conv's HWOI ->
    (cin, cout, kh, kw) by the same permutation), 2-D w transposed, every
    other leaf (biases, BN scale/bias, running mean/var) as it is."""
    return relayout(tree, (3, 2, 0, 1), lambda a: torch.tensor(a, device=device))


def params_to_jax(tree):
    """Inverse of params_from_jax: numpy arrays in the JAX package's layout."""
    return relayout(tree, (2, 3, 1, 0), np.array)


def bn_init(c: int) -> Tuple[Dict, Dict]:
    """BatchNorm over c channels at identity: (params, running stats)."""
    return ({"scale": torch.ones(c), "bias": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})


def batchnorm(p: Dict, s: Dict, x: torch.Tensor, train: bool, momentum: float,
              eps: float) -> Tuple[torch.Tensor, Dict]:
    """(B, C, H, W) BatchNorm2d in the params' type (float32: a bf16 x is
    upcast) with params {'scale', 'bias'} and running stats s {'mean',
    'var'}. Train mode normalises by the batch mean and biased variance and
    returns new running stats (`momentum`, unbiased variance); eval mode
    uses s and returns it."""
    x = x.to(p["scale"].dtype)
    if train:
        mean, var = s["mean"].clone(), s["var"].clone()
        y = Fn.batch_norm(x, mean, var, p["scale"], p["bias"], training=True,
                          momentum=momentum, eps=eps)
        return y, {"mean": mean, "var": var}
    return Fn.batch_norm(x, s["mean"], s["var"], p["scale"], p["bias"],
                         training=False, eps=eps), s


Padding = Union[int, Tuple[Tuple[int, int], Tuple[int, int]]]


def conv(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1, groups: int = 1,
         padding: Padding = 0) -> torch.Tensor:
    """NCHW conv with an OIHW weight; `padding` is symmetric (an int) or
    ((top, bottom), (left, right))."""
    if not isinstance(padding, int):
        (t, bo), (le, r) = padding
        if t == bo and le == r:
            padding = (t, le)
        else:
            x = Fn.pad(x, (le, r, t, bo))
            padding = 0
    return Fn.conv2d(x, w, b, stride, padding, 1, groups)
