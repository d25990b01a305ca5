"""How far the float32 stage-3 (DM) gradient is from float64, and how
smooth the gradient is in the pose, at the DM parity inputs
(training/parity.py::dm_trainer: the 48x64 scene, the D=2 W=32 NeRF,
DFNet at full width; train views 1, 3 and 5, combine_loss_w [0, 0, 1] and
[0.2, 0.3, 0.5] unless given).

    python -m dfnet_tpu_torch.scripts.dm_diag [--devices cuda cpu] [--w 0,0,1]
        [--views 1 3 5]

Devices default to the card (`cuda`); without one, pass `--devices cpu`.
For each device, view and combine_loss_w, relative errors (largest
|float32 - float64| over the float64 value's largest magnitude) of:
  - chain:     the whole step: dL/dpose12 (F's output), dL/dpose (the
               render's input, after the SVD), dL/drgb and the render;
  - render:    the render's VJP alone, at the float64 pose and cotangent;
  - g_backward: G + the loss's backward alone, at the float64 render;
and, in float64, how much dL/dpose moves (relative to its scale) when the
pose moves by eps in its largest entry (three random directions each): a
move below float32's rounding of the pose that moves the gradient by more
than the parity bars means two float32 implementations can only be
compared at one render pose (parity.DM_DPOSE_OWN_POSE is set from these
moves). A last line per device and combine_loss_w gives the largest move
at each eps over the views.

The float64 runs execute the port's own code with torch.Tensor.float
mapped to double and float64 rays, inside `float64_mode`; the script
changes nothing else.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import tempfile

import numpy as np
import torch

from dfnet_tpu_torch.device import resolve_device
from dfnet_tpu_torch.models.dfnet import conv_precision
from dfnet_tpu_torch.render import rays as rays_mod
from dfnet_tpu_torch.render import volume
from dfnet_tpu_torch.training import dm_trainer, nerf_renderer, parity
from dfnet_tpu_torch.training.nerf_trainer import tree_map


def _get_rays64(H, W, focal, c2w):
    c2w = c2w.double()
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=c2w.device),
                          torch.arange(W, dtype=torch.float64, device=c2w.device),
                          indexing="ij")
    dirs = torch.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal,
                        -torch.ones_like(i)], -1)
    rays_d = torch.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
    return c2w[:3, -1].expand(rays_d.shape), rays_d


@contextlib.contextmanager
def float64_mode():
    """The port's float32 code paths in float64 inside the block."""
    to_float, get_rays = torch.Tensor.float, rays_mod.get_rays
    mods = (volume, nerf_renderer, dm_trainer)
    torch.set_default_dtype(torch.float64)
    torch.Tensor.float = lambda self: self.double()
    for m in mods:
        m.get_rays = _get_rays64
    try:
        yield
    finally:
        torch.Tensor.float = to_float
        torch.set_default_dtype(torch.float32)
        for m in mods:
            m.get_rays = get_rays


def _to64(tr) -> None:
    double = lambda t: t.double()
    tr.nerf.params = tree_map(double, tr.nerf.params)
    tr.feat_params = tree_map(double, tr.feat_params)
    tr.feat_state = tree_map(double, tr.feat_state)
    tr.net.state = tree_map(double, tr.net.state)
    with torch.no_grad():
        for _, t in tr._named:
            t.data = t.data.double()


def _chain(tr, view, dt):
    """dL/dpose12, dL/dpose, dL/drgb, the render and the pose of a step."""
    img, p12 = (torch.as_tensor(np.asarray(a)).to(tr.device, dt) for a in view[:2])
    h = torch.as_tensor(view[2]).to(tr.device)
    with conv_precision(torch.float32):
        poses = tr.predict_poses(tr.params, img[None], tr.compute_dtype)
        poses.retain_grad()
        rgbs = tr.render(tr.nerf.params, poses, h[None])
        rgbs.retain_grad()
        tr.match_losses(poses, rgbs, tr.feat_params, img[None], p12)[0][0].backward()
    np64 = lambda t: t.detach().double().cpu().numpy()
    out = dict(dpose12=np64(dict(tr._named)["fc_pose/b"].grad), dpose=np64(poses.grad),
               drgb=np64(rgbs.grad), rgb=np64(rgbs), pose=poses.detach())
    for _, t in tr._named:
        t.grad = None
    return out


def _render_vjp(tr, pose, hist, v):
    pose = pose.clone().requires_grad_()
    with conv_precision(torch.float32):
        out = tr.render(tr.nerf.params, pose, hist[None])
        (g,) = torch.autograd.grad(out, pose, grad_outputs=v.to(out.device, out.dtype))
    return g.double().cpu().numpy()


def _g_backward(tr, rgb, img, p12, pose):
    rgb = rgb.clone().requires_grad_()
    with conv_precision(torch.float32):
        loss = tr.match_losses(pose, rgb, tr.feat_params, img[None], p12)[0][0]
        (g,) = torch.autograd.grad(loss, rgb)
    return g.double().cpu().numpy()


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def _diagnose_view(t32, t64, i, eps, dirs) -> dict:
    sc = t32.scene
    view = (sc.train.images[i], sc.train.poses[i].reshape(1, 12), sc.train.hists[i])
    a = _chain(t32, view, torch.float32)
    with float64_mode():
        b = _chain(t64, view, torch.float64)
    dev = t32.device
    hist = torch.as_tensor(view[2]).to(dev)
    img = torch.as_tensor(view[0]).to(dev)
    p12 = torch.as_tensor(view[1]).to(dev)
    v64 = torch.as_tensor(b["drgb"])
    r32 = _render_vjp(t32, b["pose"].float(), hist, v64.float())
    g32 = _g_backward(t32, torch.as_tensor(b["rgb"]).float().to(dev), img, p12,
                      b["pose"].float())
    moves = {}
    with float64_mode():
        r64 = _render_vjp(t64, b["pose"], hist, v64)
        rng = np.random.default_rng(i)
        for e in eps:
            moves[str(e)] = []
            for _ in range(dirs):
                d = rng.normal(size=(1, 3, 4))
                pose = b["pose"] + torch.tensor(d * (e / np.abs(d).max()), device=dev)
                moves[str(e)].append(_rel(_chain_at(t64, view, pose), b["dpose"]))
        g64 = _g_backward(t64, torch.as_tensor(b["rgb"]).to(dev), img.double(),
                          p12.double(), b["pose"])
    return {"view": i,
            "chain": {k: _rel(a[k], b[k]) for k in ("dpose12", "dpose", "drgb", "rgb")},
            "render": _rel(r32, r64), "g_backward": _rel(g32, g64),
            "dpose_scale": float(np.abs(b["dpose"]).max()),
            "float32_pose_vs_float64": float((a["pose"].double().cpu()
                                              - b["pose"].cpu()).abs().max()),
            "float64_dpose_move": moves}


def diagnose(device, w: str, views=(1, 3, 5), eps=(1e-7, 2.4e-7, 1e-6), dirs=3):
    """One dict a view (see the module's docstring), then the largest
    float64 move at each eps over the views."""
    with tempfile.TemporaryDirectory() as base:
        t32 = parity.dm_trainer(base, device, "--combine_loss_w", w)
        t64 = parity.dm_trainer(base, device, "--combine_loss_w", w)
        _to64(t64)
        for i in views:
            out = {"device": str(t32.device), "combine_loss_w": w,
                   **_diagnose_view(t32, t64, i, eps, dirs)}
            print(json.dumps(out), flush=True)
            yield out


def _chain_at(tr, view, pose):
    """dL/dpose of the float64 loss at a given render pose."""
    img, p12 = (torch.as_tensor(np.asarray(a)).to(tr.device, torch.float64)
                for a in view[:2])
    h = torch.as_tensor(view[2]).to(tr.device)
    pose = pose.clone().requires_grad_()
    rgbs = tr.render(tr.nerf.params, pose, h[None])
    loss = tr.match_losses(pose, rgbs, tr.feat_params, img[None], p12)[0][0]
    (g,) = torch.autograd.grad(loss, pose)
    return g.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", nargs="+", default=["cuda"])
    ap.add_argument("--w", nargs="+", default=["0,0,1", "0.2,0.3,0.5"])
    ap.add_argument("--views", nargs="+", type=int, default=[1, 3, 5])
    args = ap.parse_args(argv)
    devices = [resolve_device(d) for d in args.devices]
    for dev in devices:
        for w in args.w:
            runs = list(diagnose(dev, w, args.views))
            largest = {e: max(m for r in runs for m in r["float64_dpose_move"][e])
                       for e in runs[0]["float64_dpose_move"]}
            print(json.dumps({"device": str(dev), "combine_loss_w": w, "views": args.views,
                              "largest_float64_dpose_move": largest}), flush=True)


if __name__ == "__main__":
    main()
