"""render/fast.py's PackCache on the CPU, where the kernels run their plain
versions: the trainer's render and FrozenNeRF.render_at_pose pack the
weights once per weight version (PACKS counts a miss, then hits), every
cached view is bit-equal to a view rendered with a fresh pack, and an
Adam step, an in-place write to one leaf or a loaded params tree makes the
next view pack anew.

Imports neither JAX nor dfnet_tpu. Tiny sizes: D=2 W=32 NeRF-H, 16+16
samples, 12x16 views."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import numpy as np
import pytest
import torch

from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.render import fast
from dfnet_tpu_torch.training.checkpoints import params_to_numpy
from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF
from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer

SMALL = ["--NeRFH", "--encode_hist", "--dataset_type", "synthetic",
         "--netdepth", "2", "--netwidth", "32", "--netdepth_fine", "2",
         "--netwidth_fine", "32", "--N_samples", "16", "--N_importance", "16",
         "--N_rand", "64", "--expname", "nerfh"]
CULLED = ["--render_cull_q", "2e-3", "--render_fine_total", "8",
          "--render_place_samples", "8"]
WORLD = {"pose_scale": 0.8, "pose_scale2": 1.25, "move_all_cam_vec": [0.1, -0.05, 0.2]}


def _trainer(tmp_path, *flags, device="cpu"):
    cfg = parse_args(SMALL + list(flags) + ["--basedir", str(tmp_path), "--device",
                                            str(device)])
    tr = NeRFTrainer(cfg, make_synthetic_scene(n_train=2, n_val=3, H=12, W=16,
                                               focal=16.0, seed=0))
    assert tr.uses_fast_render
    return tr


def _view(tr, i):
    pose = torch.as_tensor(tr.scene.val.poses[i], dtype=torch.float32, device=tr.device)
    hist = torch.as_tensor(tr.scene.val.hists[i], device=tr.device)
    return tr._render(tr.params, pose, hist, 0), pose, hist


def _fresh(tr, pose, hist):
    """The trainer's view with the weights packed for this call alone."""
    cfg = tr.cfg
    return fast.render_image_fast(tr.params, tr.model, pose, hist, tr.scene.H, tr.scene.W,
                                  tr.scene.focal, tr.settings_test,
                                  chunk=min(cfg.chunk, tr.scene.H * tr.scene.W),
                                  use_proposal=cfg.proposal_render,
                                  **fast.cull_schedule_kwargs(cfg))


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in ("rgb", "disp", "acc"))


def _packs_since(before):
    return {k: fast.PACKS[k] - before[k] for k in before}


@pytest.mark.parametrize("flags", [[], CULLED], ids=["exact", "culled"])
def test_trainer_views_pack_once_and_match_a_fresh_pack(tmp_path, flags):
    tr = _trainer(tmp_path, *flags)
    before = dict(fast.PACKS)
    for i in range(3):
        got, pose, hist = _view(tr, i)
        assert _equal(got, _fresh(tr, pose, hist)), i
    assert _packs_since(before) == {"hits": 2, "misses": 1}


@pytest.mark.parametrize("update", ["adam", "add_"])
def test_a_weight_update_packs_anew(tmp_path, update):
    tr = _trainer(tmp_path)
    stale, _, _ = _view(tr, 0)
    if update == "adam":
        tr.train_step(0, 1e-2)
    else:
        # a leaf only the pack reads: a stale pack would render `stale` again
        with torch.no_grad():
            tr.params["fine"]["xyz_0"]["w"].add_(0.05)
    before = dict(fast.PACKS)
    got, pose, hist = _view(tr, 0)
    assert _packs_since(before) == {"hits": 0, "misses": 1}
    assert _equal(got, _fresh(tr, pose, hist))
    assert not torch.equal(got["rgb"], stale["rgb"])


def test_a_loaded_params_tree_packs_anew(tmp_path):
    tr = _trainer(tmp_path)
    _view(tr, 0)
    tr.load_params_tree(params_to_numpy(tr.params))    # the same values, new tensors
    before = dict(fast.PACKS)
    got, pose, hist = _view(tr, 0)
    assert _packs_since(before) == {"hits": 0, "misses": 1}
    assert _equal(got, _fresh(tr, pose, hist))


def test_frozen_nerf_packs_once():
    cfg = parse_args(SMALL + ["--device", "cpu"], stage="nerf")
    nerf = FrozenNeRF(cfg, (12, 16, 16.0), 0.5, 3.5, WORLD)
    assert nerf.uses_fast_render
    pose = np.concatenate([np.eye(3), [[0.1], [0.0], [1.2]]], -1).astype(np.float32)
    hist = np.random.default_rng(0).integers(0, 20, 10).astype(np.int32)
    before = dict(fast.PACKS)
    first = nerf.render_at_pose(pose, hist)
    assert torch.equal(nerf.render_at_pose(pose, hist), first)
    assert _packs_since(before) == {"hits": 1, "misses": 1}
