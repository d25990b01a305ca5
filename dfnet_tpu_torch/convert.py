"""Converters between the reference's PyTorch checkpoints and the port's
param trees (port of dfnet_tpu/convert.py).

The reference's two formats (run_nerf.py:150-167, dm/callbacks.py:90-100):
  - NeRF-H `.tar` dicts: network_fn/fine_state_dict + embedding_a/t;
  - DFNet/DFNet_dm `.pt` bare state_dicts (torchvision VGG16 encoder +
    adaptation layers + fc_pose).
Also a torchvision vgg16 state_dict (ImageNet weights) for DFNet's
encoder init.

Layouts:
  - the port's NeRF trees are the JAX package's: numpy, Linear `w` as
    (in, out), so torch Linear weights (out, in) are transposed;
  - the port's DFNet trees are torch's own (conv OIHW, `fc_pose.w` as
    (out, in); models/dfnet.py), so a `.pt` -> port DFNet is a renaming.
    The `.npz` that `main` writes is the shared JAX-layout file
    (models/dfnet.py::dfnet_params_to_jax), which either package loads.

A missing key raises KeyError naming it; extra keys (num_batches_tracked)
are ignored.

    python -m dfnet_tpu_torch.convert <src> <dst> [--kind nerf|dfnet|vgg16] [--netdepth D]
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from dfnet_tpu_torch.models.dfnet import dfnet_params_from_jax, dfnet_params_to_jax
from dfnet_tpu_torch.models.vgg import CONV_NAMES, TORCH_CONV_INDEX


def _load_torch(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _to_np(sd: Dict) -> Dict[str, np.ndarray]:
    return {k: _np(v) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# NeRF-H (JAX layout, numpy)
# ---------------------------------------------------------------------------

def _t_lin(sd: Dict[str, np.ndarray], name: str) -> Dict:
    return {"w": np.ascontiguousarray(sd[f"{name}.weight"].T), "b": sd[f"{name}.bias"]}


def nerfw_state_dict_to_params(sd: Dict, D: int = 8,
                               encode_transient: bool = False) -> Dict:
    """One NeRFW module's state_dict -> the port's param dict (reference
    layer names: nerfw.py:258-295)."""
    sd = _to_np(sd)
    p = {f"xyz_{i}": _t_lin(sd, f"xyz_encoding_{i + 1}.0") for i in range(D)}
    p["xyz_final"] = _t_lin(sd, "xyz_encoding_final")
    p["dir"] = _t_lin(sd, "dir_encoding.0")
    p["static_sigma"] = _t_lin(sd, "static_sigma.0")
    p["static_rgb"] = _t_lin(sd, "static_rgb.0")
    if encode_transient or any(k.startswith("transient_encoding") for k in sd):
        for i in range(4):
            p[f"trans_{i}"] = _t_lin(sd, f"transient_encoding.{2 * i}")
        p["trans_sigma"] = _t_lin(sd, "transient_sigma.0")
        p["trans_rgb"] = _t_lin(sd, "transient_rgb.0")
        p["trans_beta"] = _t_lin(sd, "transient_beta.0")
    return p


def convert_nerf_checkpoint(tar_path: str, D: int = 8) -> Tuple[Dict, Dict]:
    """Reference `.tar` -> ({'coarse', 'fine', 'embedding_a', 'embedding_t'},
    {'global_step'}). A `.tar` holds no proposal net."""
    ckpt = _load_torch(tar_path)
    out = {"coarse": nerfw_state_dict_to_params(ckpt["network_fn_state_dict"], D)}
    if "network_fine_state_dict" in ckpt:
        out["fine"] = nerfw_state_dict_to_params(ckpt["network_fine_state_dict"], D,
                                                 encode_transient=True)
        out["embedding_a"] = _to_np(ckpt["embedding_a_state_dict"])["weight"]
        out["embedding_t"] = _to_np(ckpt["embedding_t_state_dict"])["weight"]
    return out, {"global_step": int(ckpt.get("global_step", 0))}


def _rev_lin(sd: Dict, name: str, p: Dict) -> None:
    sd[f"{name}.weight"] = torch.tensor(np.ascontiguousarray(_np(p["w"]).T))
    sd[f"{name}.bias"] = torch.tensor(_np(p["b"]))


def nerfw_params_to_state_dict(p: Dict) -> Dict:
    """Inverse of nerfw_state_dict_to_params: the port's NeRFW param dict
    (numpy or tensors) -> the reference's layer naming."""
    sd: Dict = {}
    D = sum(1 for k in p if k.startswith("xyz_") and k != "xyz_final")
    for i in range(D):
        _rev_lin(sd, f"xyz_encoding_{i + 1}.0", p[f"xyz_{i}"])
    _rev_lin(sd, "xyz_encoding_final", p["xyz_final"])
    _rev_lin(sd, "dir_encoding.0", p["dir"])
    _rev_lin(sd, "static_sigma.0", p["static_sigma"])
    _rev_lin(sd, "static_rgb.0", p["static_rgb"])
    if "trans_sigma" in p:
        for i in range(4):
            _rev_lin(sd, f"transient_encoding.{2 * i}", p[f"trans_{i}"])
        _rev_lin(sd, "transient_sigma.0", p["trans_sigma"])
        _rev_lin(sd, "transient_rgb.0", p["trans_rgb"])
        _rev_lin(sd, "transient_beta.0", p["trans_beta"])
    return sd


def export_nerf_checkpoint(params: Dict, tar_path: str, global_step: int = 0) -> None:
    """The port's {'coarse', 'fine', 'embedding_a', 'embedding_t'} tree ->
    the reference's `.tar` dict (its exact key set, nerfw.py:452-472 /
    run_nerf.py:150-167). A proposal subtree has no place there and is
    left out."""
    ckpt = {"global_step": int(global_step),
            "network_fn_state_dict": nerfw_params_to_state_dict(params["coarse"])}
    if "fine" in params:
        ckpt["network_fine_state_dict"] = nerfw_params_to_state_dict(params["fine"])
        ckpt["embedding_a_state_dict"] = {"weight": torch.tensor(_np(params["embedding_a"]))}
        ckpt["embedding_t_state_dict"] = {"weight": torch.tensor(_np(params["embedding_t"]))}
    torch.save(ckpt, tar_path)


# ---------------------------------------------------------------------------
# DFNet / VGG16 (torch layout, tensors)
# ---------------------------------------------------------------------------

def _conv(sd: Dict, name: str, device) -> Dict:
    return {"w": sd[f"{name}.weight"].to(device), "b": sd[f"{name}.bias"].to(device)}


def _tensors(sd: Dict) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).detach().clone() for k, v in sd.items()}


def _encoder(sd: Dict[str, torch.Tensor], prefix: str, device) -> Dict:
    return {name: _conv(sd, f"{prefix}{TORCH_CONV_INDEX[name]}", device)
            for name in CONV_NAMES}


def vgg16_state_dict_to_params(sd: Dict, prefix: str = "", device="cpu") -> Dict:
    """torchvision vgg16 `features` weights -> the port's encoder params
    ('features.{idx}' naming with prefix='features.', DFNet checkpoints'
    'encoder.{idx}' with prefix='encoder.')."""
    return _encoder(_tensors(sd), prefix, device)


def convert_vgg16_imagenet(path: str, device="cpu") -> Dict:
    """A torchvision vgg16 ImageNet state_dict file -> encoder params."""
    return vgg16_state_dict_to_params(_load_torch(path), prefix="features.", device=device)


def convert_dfnet_checkpoint(pt_path: str, device="cpu") -> Tuple[Dict, Dict]:
    """A reference DFNet `.pt` state_dict -> the port's (params, state)."""
    sd = _tensors(_load_torch(pt_path))
    params: Dict = {"encoder": _encoder(sd, "encoder.", device), "adapt": {}}
    state: Dict = {"adapt": {}}
    i = 0
    while f"adaptation_layers.adapt_layer_{i}.0.weight" in sd:
        base = f"adaptation_layers.adapt_layer_{i}"
        params["adapt"][str(i)] = {
            "conv1": _conv(sd, f"{base}.0", device),
            "conv2": _conv(sd, f"{base}.2", device),
            "bn_scale": sd[f"{base}.3.weight"].to(device),
            "bn_bias": sd[f"{base}.3.bias"].to(device)}
        state["adapt"][str(i)] = {"mean": sd[f"{base}.3.running_mean"].to(device),
                                  "var": sd[f"{base}.3.running_var"].to(device)}
        i += 1
    params["fc_pose"] = {"w": sd["fc_pose.weight"].to(device),
                         "b": sd["fc_pose.bias"].to(device)}
    return params, state


def export_dfnet_checkpoint(params: Dict, state: Dict, pt_path: str) -> None:
    """The port's DFNet (params, state) -> the reference's `.pt` bare
    state_dict (dm/callbacks.py:90-100 naming: encoder.{idx} /
    adaptation_layers.adapt_layer_{i} / fc_pose)."""
    t = lambda a: torch.as_tensor(a).detach().cpu().clone()
    sd: Dict = {}

    def put(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = t(p["w"]), t(p["b"])

    for name in CONV_NAMES:
        put(f"encoder.{TORCH_CONV_INDEX[name]}", params["encoder"][name])
    for i in sorted(params["adapt"], key=int):
        base, p, s = f"adaptation_layers.adapt_layer_{i}", params["adapt"][i], state["adapt"][i]
        put(f"{base}.0", p["conv1"])
        put(f"{base}.2", p["conv2"])
        sd[f"{base}.3.weight"], sd[f"{base}.3.bias"] = t(p["bn_scale"]), t(p["bn_bias"])
        sd[f"{base}.3.running_mean"], sd[f"{base}.3.running_var"] = t(s["mean"]), t(s["var"])
        sd[f"{base}.3.num_batches_tracked"] = torch.tensor(0)
    put("fc_pose", params["fc_pose"])
    torch.save(sd, pt_path)


def main(argv=None):
    """python -m dfnet_tpu_torch.convert <in.tar|in.pt> <out.npz> [--kind
    nerf|dfnet|vgg16]: a reference checkpoint -> the shared `.npz`. An
    `.npz` source with a `.tar` / `.pt` destination exports it back to the
    reference format."""
    import argparse

    from dfnet_tpu_torch.training.checkpoints import load_pytree, save_pytree

    ap = argparse.ArgumentParser(description="Convert reference torch checkpoints to "
                                 "the shared npz pytrees (or export npz back to the "
                                 "reference's torch formats)")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--kind", choices=["nerf", "dfnet", "vgg16"], default=None)
    ap.add_argument("--netdepth", type=int, default=8)
    args = ap.parse_args(argv)

    if args.src.endswith(".npz"):  # export: shared npz -> reference format
        tree, meta = load_pytree(args.src)
        params = tree.get("params", tree)
        if args.dst.endswith(".tar"):
            export_nerf_checkpoint(params, args.dst,
                                   global_step=int(meta.get("global_step", 0)))
        else:
            export_dfnet_checkpoint(*dfnet_params_from_jax(params, tree["state"]), args.dst)
        print(f"exported {args.src} -> {args.dst} (reference format)")
        return

    kind = args.kind or ("nerf" if args.src.endswith(".tar") else "dfnet")
    if kind == "nerf":
        params, meta = convert_nerf_checkpoint(args.src, D=args.netdepth)
        save_pytree(args.dst, {"params": params}, **meta)
    elif kind == "dfnet":
        params, state = dfnet_params_to_jax(*convert_dfnet_checkpoint(args.src))
        save_pytree(args.dst, {"params": params, "state": state})
    else:
        save_pytree(args.dst, {"encoder": dfnet_params_to_jax(
            convert_vgg16_imagenet(args.src), {})[0]})
    print(f"converted {args.src} ({kind}) -> {args.dst}")


if __name__ == "__main__":
    main()
