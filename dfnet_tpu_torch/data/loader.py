"""Dataset loader factory (port of dfnet_tpu/data/loader.py, synthetic
branch). The 7-Scenes and Cambridge readers are a later slice of the port
(ROADMAP.md, Queue 1 "Real-dataset readers")."""

from __future__ import annotations

import numpy as np

from dfnet_tpu_torch.config import Config
from dfnet_tpu_torch.data.scene import SceneData
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.device import resolve_device


def load_scene(cfg: Config, stage: str = "nerf") -> SceneData:
    """stage: 'nerf' (rescale into NeRF coords) or 'apr' (keep metric frame)."""
    if cfg.dataset_type == "synthetic":
        # 48x64 keeps VGG16's five 2x2 pools valid (each side >= 32)
        scene = make_synthetic_scene(H=48, W=64, focal=60.0, seed=cfg.rng_seed,
                                     device=resolve_device(cfg.device))
        if cfg.NeRFH and not cfg.encode_hist:
            _relabel_with_indices(scene, cfg.fix_index)
        return scene
    if cfg.dataset_type in ("7Scenes", "Cambridge"):
        raise NotImplementedError(
            f"dataset_type {cfg.dataset_type!r}: the real-dataset readers are "
            "not ported yet (ROADMAP.md, Queue 1 'Real-dataset readers')")
    raise ValueError(f"unknown dataset_type {cfg.dataset_type!r}")


def _relabel_with_indices(scene: SceneData, fix_index: bool):
    """NeRF-W per-image-index embedding labels (NeRFH with
    encode_hist=False): train images carry their split position (or 0
    under --fix_index), val images carry 0."""
    n_tr = len(scene.train)
    tr_idx = np.zeros(n_tr, np.int32) if fix_index else np.arange(n_tr, dtype=np.int32)
    scene.train.hists = tr_idx[:, None]
    scene.val.hists = np.zeros((len(scene.val), 1), np.int32)


def epoch_permutation(n: int, rng: np.random.Generator) -> np.ndarray:
    """The order of one epoch's train images, from the caller's generator."""
    return rng.permutation(n)
