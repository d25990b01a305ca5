"""One step of each stage on a data mesh, as the tests and chip_smoke.py
hold it against one device.

Each function runs alone (mesh None: world 1) or on every rank inside
parallel/mesh.py::launch (world n), builds its trainer from the same
config, params and inputs, and returns what it computed as numpy: rank
0's value of what every rank holds (the loss, the grads by leaf path, the
BN running statistics, a render), plus every rank's kernel launches.
`skip_reduce=True` is the control: every rank skips the grads' all-reduce,
so rank 0 returns its own share, which must miss the one-device grads.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dfnet_tpu_torch.ops import nerf_kernels as nk
from dfnet_tpu_torch.parallel.mesh import Mesh, rank_and_size


def per_rank(obj) -> list:
    """obj of every rank, in rank order ([obj] alone)."""
    size = rank_and_size()[1]
    if size == 1:
        return [obj]
    out = [None] * size
    dist.all_gather_object(out, obj)
    return out


def _grads(named) -> Dict[str, np.ndarray]:
    return {k: (t.grad if t.grad is not None else torch.zeros_like(t)).cpu().numpy()
            for k, t in named}


def _shares(names, shares: list) -> list:
    """Every rank's weighted grads before its one reduce, by leaf path, in
    rank order (empty without a mesh)."""
    return [dict(zip(names, s[0])) for s in per_rank(shares) if s]


@contextlib.contextmanager
def _grad_reduce(skip: bool, *modules, shares: Optional[list] = None):
    """With skip, each module's all_reduce_grads_ returns at once (the
    control: no rank sums its grads with the others'). With `shares`, each
    reduce first appends this rank's weighted grads (numpy, in the leaves'
    order) to it."""
    saved = [m.all_reduce_grads_ for m in modules]

    def spy(f):
        def reduce(leaves, weight=1.0, extra=None):
            if shares is not None:
                shares.append([np.zeros(t.shape, np.float32) if t.grad is None else
                               weight * t.grad.float().cpu().numpy() for t in leaves])
            return extra if skip else f(leaves, weight, extra)
        return reduce

    for m, f in zip(modules, saved):
        m.all_reduce_grads_ = spy(f)
    try:
        yield
    finally:
        for m, f in zip(modules, saved):
            m.all_reduce_grads_ = f


def stage1_step(cfg, scene, params: Optional[Dict] = None, mesh: Optional[Mesh] = None,
                idx: int = 0, rays: Optional[Sequence[np.ndarray]] = None,
                epoch: float = 0.0, skip_reduce: bool = False) -> Dict:
    """The stage-1 step's loss, MSE and grads on train image `idx`'s
    N_rand pixels drawn by the trainer (or on `rays`: rays_o, rays_d,
    target, hist), from `params` (a numpy tree; default the seeded init),
    and on a mesh each rank's weighted share of the grads before they were
    summed (`shares`, by leaf path, in rank order)."""
    from dfnet_tpu_torch.training import nerf_trainer
    from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer

    tr = NeRFTrainer(cfg, scene, mesh=mesh)
    if params is not None:
        tr.load_params_tree(params)
    batch = (tr.draw_batch(idx) if rays is None else
             [torch.as_tensor(a, device=tr.device) for a in rays])
    nk.reset_launches()
    shares = []
    with _grad_reduce(skip_reduce, nerf_trainer, shares=shares):
        loss, mse = tr.loss_and_grads(*batch, epoch)
    return dict(loss=float(loss), mse=float(mse), grads=_grads(tr._named),
                fused=tr.uses_fused_train, launches=per_rank(dict(nk.LAUNCHES)),
                shares=_shares([k for k, _ in tr._named], shares))


def render_view(cfg, scene, params: Dict, pose: np.ndarray, hist: np.ndarray,
                mesh: Optional[Mesh] = None) -> Dict:
    """The stage-1 trainer's eval render of one view (split over the mesh's
    ray axis): rgb, disp and acc, whether the kernels served it, and every
    rank's launches."""
    from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer

    tr = NeRFTrainer(cfg, scene, mesh=mesh)
    tr.load_params_tree(params)
    nk.reset_launches()
    out = tr._render(tr.params, torch.as_tensor(pose, dtype=torch.float32, device=tr.device),
                     torch.as_tensor(hist, device=tr.device), 0)
    return dict({k: v.cpu().numpy() for k, v in out.items()}, fast=tr.uses_fast_render,
                launches=per_rank(dict(nk.LAUNCHES)))


def frozen_prerender(cfg, hwf, near: float, far: float, world_setup: Dict, params: Dict,
                     poses: np.ndarray, hists: np.ndarray,
                     mesh: Optional[Mesh] = None) -> Dict:
    """FrozenNeRF.prerender_views of the poses (each view's rays split over
    the mesh), and every rank's launches."""
    from dfnet_tpu_torch.training.checkpoints import params_from_numpy
    from dfnet_tpu_torch.training.nerf_renderer import FrozenNeRF

    dev = mesh.device() if mesh is not None else cfg.device
    nerf = FrozenNeRF(cfg, hwf, near, far, world_setup, mesh=mesh, device=dev,
                      params=params_from_numpy(params, dev))
    nk.reset_launches()
    rgb = nerf.prerender_views(poses, hists, log_every=0)
    return dict(rgb=rgb, fast=nerf.uses_fast_render, launches=per_rank(dict(nk.LAUNCHES)))


def stage2_step(cfg, scene, batch: Sequence[np.ndarray], mesh: Optional[Mesh] = None,
                skip_reduce: bool = False) -> Dict:
    """The stage-2 step's loss, grads, new BN running statistics and the
    ranks' shares (stage1_step's) on `batch` (targets, renders, poses
    (B, 12)[, RVS views, RVS poses]; images NCHW) from cfg's DFNet
    (pretrain_model_path, else the seeded init)."""
    from dfnet_tpu_torch.models.dfnet import dfnet_params_to_jax
    from dfnet_tpu_torch.training import feature_trainer
    from dfnet_tpu_torch.training.feature_trainer import FeatureTrainer

    t = FeatureTrainer(cfg, scene, None, mesh=mesh)
    args = [torch.as_tensor(b, device=t.device) for b in batch]
    shares = []
    with _grad_reduce(skip_reduce, feature_trainer, shares=shares):
        loss, state = t.loss_and_grads(*args)
    return dict(loss=float(loss), grads=_grads(t._named),
                state=dfnet_params_to_jax({}, state)[1],
                shares=_shares([k for k, _ in t._named], shares))


def stage3_step(base: str, flags: Sequence[str], image: np.ndarray, pose12: np.ndarray,
                hist: np.ndarray, render_pose: Optional[np.ndarray] = None,
                mesh: Optional[Mesh] = None, skip_reduce: bool = False) -> Dict:
    """The DM step (training/parity.py::dm_trainer's trainer, whose renders
    split over the mesh) on one image: loss, PSNR, F's grads and its
    predicted pose, rendering at `render_pose` when given, every rank's
    launches and the ranks' shares (stage1_step's)."""
    from dfnet_tpu_torch.training import dm_trainer, parity

    dev = mesh.device() if mesh is not None else torch.device("cpu")
    tr = parity.dm_trainer(base, dev, *flags, mesh=mesh)
    nk.reset_launches()
    shares = []
    with _grad_reduce(skip_reduce, dm_trainer, shares=shares):
        loss, psnr, grads, pose = parity.dm_loss_and_grads(tr, image, pose12, hist,
                                                           render_pose)
    return dict(loss=loss, psnr=psnr, grads=grads, pose=pose,
                launches=per_rank(dict(nk.LAUNCHES)),
                shares=_shares([k for k, _ in tr._named], shares))


def collectives(device: str = "cpu") -> Dict:
    """mesh.gather_rows and mesh.all_reduce_grads_ on this rank's tensors
    on `device`, beside their closed forms: rank r holds r + 1 rows of
    x_r = 100 r + arange (3 columns); the gathered rows are weighted by
    (s + 1) on rank s and summed, so x_r's grad is the sum of those
    weights over ranks; leaf a has grad r + 1, leaf b none on rank 0 and
    r + 1 elsewhere, reduced at weight 1/n with the rank as `extra`."""
    from dfnet_tpu_torch.parallel.mesh import all_reduce_grads_, gather_rows

    rank, n = rank_and_size()
    dev = torch.device(device)
    rows = [r + 1 for r in range(n)]

    def block(r):
        return 100.0 * r + torch.arange(rows[r] * 3, dtype=torch.float32,
                                        device=dev).reshape(rows[r], 3)

    x = block(rank).requires_grad_(True)
    y = gather_rows(x, rows)
    w = torch.arange(y.numel(), dtype=torch.float32, device=dev).reshape(y.shape)
    (y * w * (rank + 1)).sum().backward()
    a = torch.zeros(4, device=dev, requires_grad=True)
    b = torch.zeros(2, 3, device=dev, requires_grad=True)
    a.grad = torch.full_like(a, rank + 1.0)
    if rank:
        b.grad = torch.full_like(b, rank + 1.0)
    extra = all_reduce_grads_([a, b], 1.0 / n, torch.tensor([float(rank)], device=dev))
    lo = sum(rows[:rank])
    want_grad = w[lo:lo + rows[rank]] * sum(s + 1 for s in range(n))
    return per_rank(dict(
        gathered=y.detach().cpu().numpy(),
        want_gathered=torch.cat([block(r) for r in range(n)]).cpu().numpy(),
        grad=x.grad.cpu().numpy(), want_grad=want_grad.cpu().numpy(),
        a=a.grad.cpu().numpy(), want_a=np.full(4, (n + 1) / 2, np.float32),
        b=b.grad.cpu().numpy(),
        want_b=np.full((2, 3), (sum(range(2, n + 1))) / n, np.float32),
        extra=extra.cpu().numpy(), want_extra=np.array([(n - 1) / 2], np.float32),
        device=str(y.device)))


def run_all(jobs: Sequence[tuple]) -> list:
    """Each (function name of this module, kwargs) in turn: one launch of
    the ranks serves several checks."""
    return [globals()[name](**kw) for name, kw in jobs]
