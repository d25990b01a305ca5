"""Vanilla NeRF MLP, the reference's non-NeRFH mode (port of
dfnet_tpu/models/nerf_vanilla.py, with the same param names and shapes).

D linear layers on the xyz encoding with ReLU; for i in skips the input is
concatenated AFTER layer i's ReLU (NeRF-W concatenates before the skip
layer). With viewdirs: an alpha head on the trunk, feature_linear, then
[feature, viewdirs] -> one W//2 layer -> rgb. Outputs are raw: the sigmoid
and the ReLU are applied in compositing (render/volume.py::composite_vanilla).

Params are {'w': (in, out), 'b': (out,)} dicts, the JAX package's layout,
as the port's NeRF-H trees are, so a stage-1 `.npz` serves both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from dfnet_tpu_torch.models.nerfw import dense, linear_init, mm


@dataclass(frozen=True)
class VanillaNeRFConfig:
    D: int = 8
    W: int = 256
    skips: tuple = (4,)
    in_xyz: int = 63
    in_dir: int = 27
    use_viewdirs: bool = True
    output_ch: int = 4
    compute_dtype: torch.dtype = torch.float32


def init_nerf_params(gen: torch.Generator, cfg: VanillaNeRFConfig, device="cpu") -> Dict:
    """torch.nn.Linear's default init for every layer, drawn from `gen`."""
    p: Dict = {}
    for i in range(cfg.D):
        # layer i reads W, or W + in_xyz when the previous layer is a skip
        if i == 0:
            fan_in = cfg.in_xyz
        elif (i - 1) in cfg.skips:
            fan_in = cfg.W + cfg.in_xyz
        else:
            fan_in = cfg.W
        p[f"pts_{i}"] = linear_init(gen, fan_in, cfg.W, device)
    if cfg.use_viewdirs:
        p["feature"] = linear_init(gen, cfg.W, cfg.W, device)
        p["alpha"] = linear_init(gen, cfg.W, 1, device)
        p["views_0"] = linear_init(gen, cfg.W + cfg.in_dir, cfg.W // 2, device)
        p["rgb"] = linear_init(gen, cfg.W // 2, 3, device)
    else:
        p["output"] = linear_init(gen, cfg.W, cfg.output_ch, device)
    return p


def nerf_apply_rays(params: Dict, cfg: VanillaNeRFConfig,
                    xyz_emb: torch.Tensor,                   # (N, S, in_xyz)
                    dir_emb: Optional[torch.Tensor] = None,  # (N, in_dir)
                    ) -> torch.Tensor:
    """Raw outputs (N, S, 4): [rgb_raw, sigma_raw] (output_ch without
    viewdirs). The per-ray viewdir input multiplies its weight rows once a
    ray (a split matmul), with no per-sample broadcast."""
    dt = cfg.compute_dtype
    h = xyz_emb
    for i in range(cfg.D):
        h = torch.relu(dense(params[f"pts_{i}"], h, dt))
        if i in cfg.skips:
            h = torch.cat([xyz_emb, h], -1)
    if not cfg.use_viewdirs:
        return dense(params["output"], h, dt)
    alpha = dense(params["alpha"], h, dt)
    feature = dense(params["feature"], h, dt)
    wv = params["views_0"]["w"]
    per_ray = mm(dir_emb, wv[cfg.W:], dt)
    hh = torch.relu(mm(feature, wv[:cfg.W], dt) + per_ray[:, None, :]
                    + params["views_0"]["b"])
    rgb = dense(params["rgb"], hh, dt)
    return torch.cat([rgb, alpha], -1)


def vanilla_state_dict_to_params(sd: Dict, D: int = 8) -> Dict:
    """Reference torch NeRF state_dict -> the params tree, numpy arrays in
    the JAX package's layout (Linear weights transposed to (in, out))."""
    sd = {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
          for k, v in sd.items()}

    def lin(name):
        return {"w": np.ascontiguousarray(sd[f"{name}.weight"].T),
                "b": np.asarray(sd[f"{name}.bias"])}

    p = {f"pts_{i}": lin(f"pts_linears.{i}") for i in range(D)}
    if "feature_linear.weight" in sd:
        p["feature"] = lin("feature_linear")
        p["alpha"] = lin("alpha_linear")
        p["views_0"] = lin("views_linears.0")
        p["rgb"] = lin("rgb_linear")
    else:
        p["output"] = lin("output_linear")
    return p
