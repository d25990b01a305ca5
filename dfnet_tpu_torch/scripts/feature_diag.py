"""Where the stage-2 step goes and how float32 DFNet agrees across devices,
on one card:

    python -m dfnet_tpu_torch.scripts.feature_diag [--steps 3] [--parts validate ...]

Prints, one JSON object a line:
  - "conv_grad_error": each conv of DFNet at the golden stage-2 inputs
    (training/parity.py: 4+4+4 images of 32x48), its weight and input
    gradients on the card against float64 on the CPU, from the same float32
    inputs and a seeded cotangent: cuDNN (TF32 off) and PyTorch's own
    convolution (models/dfnet.py::conv_precision), with the CPU's float32
    beside them;
  - "flips": the ReLU masks, max-pool choices and triplet hinges of the
    golden forward that the card and the CPU decide differently (float32,
    with the training step's precision: no cuDNN);
  - "upsample_bwd_ms": the feature upsample's backward to 240x320 from the
    conv3_3 and conv5_3 taps' sizes, torch's interpolate against the port's
    two matmuls, bf16 and float32;
  - "profile": a bf16 step at configs/config_dfnet.txt (240x320, batch 4,
    RVS) under torch.profiler: the kernels with the most device time, the
    device's busy time a step against the step's host time (the idle share);
  - "validate": the float32 eval forward (FeatureTrainer.predict, eval-mode
    BN) over 1,000 random 240x320 views in batches of 8, the val split of
    7-Scenes heads at configs/config_dfnet.txt: its ms as the port runs it
    (no cuDNN) against cuDNN with TF32 off, and the two's largest pose
    difference.
--parts picks some of these (default: all).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from unittest import mock

import torch
import torch.nn.functional as Fn

from dfnet_tpu_torch.config import parse_args
from dfnet_tpu_torch.data.synthetic import make_synthetic_scene
from dfnet_tpu_torch.models import dfnet as dm
from dfnet_tpu_torch.models.vgg import VGG16_LAYOUT, conv2d, imagenet_normalize
from dfnet_tpu_torch.ops.resize import resize_bilinear_nchw
from dfnet_tpu_torch.training import parity
from dfnet_tpu_torch.training.feature_trainer import FeatureTrainer
from dfnet_tpu_torch.utils.timing import cuda_ms


def golden_trainer(device):
    sc = make_synthetic_scene(n_train=4, n_val=2, H=32, W=48, focal=45.0)
    cfg = parse_args(parity.GOLDEN_FLAGS + ["--featurenet_batch_size", "4", "--basedir",
                                            "logs/feature_diag", "--device", str(device)],
                     stage="feature")
    return FeatureTrainer(cfg, sc, None, gen=torch.Generator().manual_seed(0))


def conv_inputs(tr, x):
    """(name, layer params, input, padding) of every DFNet conv on x (CPU)."""
    out, h, taps = [], imagenet_normalize(x), {}
    with torch.no_grad():
        for e in VGG16_LAYOUT:
            if e == "M":
                h = Fn.max_pool2d(h, 2, 2)
                continue
            p = tr.params["encoder"][e[0]]
            out.append((e[0], p, h, 1))
            h = conv2d(p, h)
            taps[e[0]] = h[:8]
            h = torch.relu(h)
        for i, name in enumerate(tr.model_cfg.hypercolumn_layers):
            a = tr.params["adapt"][str(i)]
            out.append((f"adapt{i}.conv1", a["conv1"], taps[name], 0))
            h1 = torch.relu(conv2d(a["conv1"], taps[name]))
            out.append((f"adapt{i}.conv2", a["conv2"], h1, 2))
    return out


def conv_grad_error(tr, x, device):
    rows = {}
    g = torch.Generator().manual_seed(0)
    for name, p, h, pad in conv_inputs(tr, x):
        w = p["w"].detach()
        dout = torch.randn((h.shape[0], w.shape[0]) + h.shape[2:], generator=g)
        ref_w = torch.nn.grad.conv2d_weight(h.double(), w.shape, dout.double(), padding=pad)
        ref_i = torch.nn.grad.conv2d_input(h.shape, w.double(), dout.double(), padding=pad)
        err = lambda a, b: float((a.double().cpu() - b).abs().max() / b.abs().max())
        row = {"cpu_float32_wgrad": err(torch.nn.grad.conv2d_weight(h, w.shape, dout,
                                                                    padding=pad), ref_w)}
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        for label, ctx in (("cudnn", torch.backends.cudnn.flags(enabled=True,
                                                                allow_tf32=False)),
                           ("torch", dm.conv_precision(torch.float32))):
            with ctx:
                hw, dw = h.to(device), dout.to(device)
                row[f"{label}_wgrad"] = err(torch.nn.grad.conv2d_weight(
                    hw, w.shape, dw, padding=pad), ref_w)
                row[f"{label}_dgrad"] = err(torch.nn.grad.conv2d_input(
                    h.shape, w.to(device), dw, padding=pad), ref_i)
        torch.backends.cudnn.allow_tf32 = prev
        rows[name] = row
    return rows


def decisions(tr, x, batch, device):
    """The ReLU signs, max-pool choices and triplet hinges of the golden
    forward on `device`, as CPU tensors."""
    out, h = {}, imagenet_normalize(x.to(device))
    # entered with grad on, as a training step enters it: no cuDNN
    with dm.conv_precision(torch.float32), torch.no_grad():
        for e in VGG16_LAYOUT:
            if e == "M":
                h, idx = Fn.max_pool2d(h, 2, 2, return_indices=True)
                out[f"pool{len(out)}"] = (h > 0).cpu() * (idx.cpu() + 1)
                continue
            h = conv2d(tr.params["encoder"][e[0]], h)
            out[e[0]] = (h > 0).cpu()
            if e[0] in tr.model_cfg.hypercolumn_layers:
                i = tr.model_cfg.hypercolumn_layers.index(e[0])
                out[f"adapt{i}.conv1"] = (conv2d(tr.params["adapt"][str(i)]["conv1"],
                                                 h[:8]) > 0).cpu()
            h = torch.relu(h)
        b = [t.to(device) for t in batch]
        (f_t, f_r), _, _ = dm.dfnet_forward(
            tr.params, tr.state, torch.cat([b[0], b[1], b[3]]), tr.model_cfg,
            return_feature=True, feature_count=8, upsample_h=32, upsample_w=48)
        a, p = f_r, f_t
        an, n = torch.roll(a, 1, dims=1), torch.roll(p, 1, dims=1)
        cases = ((a, p, n), (p, a, an), (a, p, an), (p, a, n))
        k = int(torch.stack([((u - v) ** 2).mean() for u, _, v in cases]).argmin())
        u, v, w = cases[k]
        d = lambda s, t: torch.sqrt(((s - t + 1e-6) ** 2).sum(tr.triplet_axis))
        out["hinge"] = (d(u, v) - d(u, w) + tr.cfg.triplet_margin > 0).cpu()
        out["case"] = torch.tensor(k)
    return out


def upsample_bwd(device):
    rows = {}
    for (h, w) in ((60, 80), (15, 20)):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(8, 128, h, w, device=device, dtype=dt, requires_grad=True)
            for label, fn in (("interpolate", lambda t: Fn.interpolate(
                    t, size=(240, 320), mode="bilinear", align_corners=True)),
                              ("matmul", lambda t: resize_bilinear_nchw(t, 240, 320))):
                y = fn(x)
                g = torch.randn_like(y)
                rows[f"{h}x{w} {str(dt)[6:]} {label}"] = cuda_ms(
                    lambda: torch.autograd.grad(y, x, g, retain_graph=True), reps=5)
    return rows


def shipped_trainer(device, n_train: int):
    """A trainer at configs/config_dfnet.txt on a 240x320 synthetic scene."""
    sc = make_synthetic_scene(n_train=n_train, n_val=2, H=240, W=320, focal=300.0,
                              device=device)
    cfg = parse_args(["--config", "configs/config_dfnet.txt", "--dataset_type", "synthetic",
                      "--basedir", "logs/feature_diag", "--device", str(device)],
                     stage="feature")
    return sc, FeatureTrainer(cfg, sc, None)


@contextlib.contextmanager
def _cudnn_float32(dtype):
    """conv_precision's stand-in for the cuDNN variant: TF32 off, cuDNN on."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yield


def validate_ms(device, n_views: int = 1000):
    _, tr = shipped_trainer(device, 2)
    x = torch.rand(n_views, 3, 240, 320, device=device,
                   generator=torch.Generator(device).manual_seed(0))
    run = lambda: torch.cat([tr.predict(b) for b in x.split(tr.cfg.val_batch_size)])
    out = {"views": n_views, "port_ms": cuda_ms(run, reps=3)}
    a = run()
    with mock.patch.object(dm, "conv_precision", _cudnn_float32):
        out["cudnn_ms"] = cuda_ms(run, reps=3)
        out["max_pose_diff"] = float((run() - a).abs().max())
    return out


def profile_step(device, steps: int):
    from torch.profiler import ProfilerActivity, profile

    sc, tr = shipped_trainer(device, 8)
    t = tr.images(sc.train.images[:4])
    batch = (t, (t * 0.9 + 0.05), tr._train_poses12[:4], tr.images(sc.train.images[4:]),
             tr._train_poses12[4:])
    for _ in range(3):
        tr.train_step(*batch, 1e-4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tr.train_step(*batch, 1e-4)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    ev = prof.key_averages()
    busy = sum(e.self_device_time_total for e in ev) / 1e3 / steps
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:25]
    return {"step_host_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "top_kernels_ms": [(e.key[:100], e.count // steps,
                                e.self_device_time_total / 1e3 / steps) for e in top]}


PARTS = ("conv_grad_error", "flips", "upsample_bwd_ms", "profile", "validate")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--parts", nargs="+", default=list(PARTS), choices=PARTS)
    args = ap.parse_args(argv)
    device = torch.device("cuda")
    if not torch.cuda.is_available():
        raise SystemExit("feature_diag needs a CUDA device")
    cpu, card = golden_trainer("cpu"), golden_trainer(device)
    batch = parity.golden_batch()
    x = torch.cat([batch[0], batch[1], batch[3]])
    if "conv_grad_error" in args.parts:
        print(json.dumps({"conv_grad_error": conv_grad_error(cpu, x, device)}), flush=True)
    if "flips" in args.parts:
        a, b = decisions(cpu, x, batch, "cpu"), decisions(card, x, batch, device)
        print(json.dumps({"flips": {k: int((a[k] != b[k]).sum()) for k in a}}), flush=True)
    if "upsample_bwd_ms" in args.parts:
        print(json.dumps({"upsample_bwd_ms": upsample_bwd(device)}), flush=True)
    if "profile" in args.parts:
        print(json.dumps({"profile": profile_step(device, args.steps)}), flush=True)
    if "validate" in args.parts:
        print(json.dumps({"validate": validate_ms(device)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
