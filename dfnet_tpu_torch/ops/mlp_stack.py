"""The layer-stack probe's kernels: D stacked W x W layers in bf16 or int8.

Port of scripts/bench_int8_wide.py::build (Pallas kernels _kernel_bf16
and _kernel_int8), a microbenchmark of the marginal cost of one MLP layer
(dfnet_tpu_torch/scripts/bench_int8_wide.py drives it). Points-major:
x is (P, W) and each weight (W, W) is (out, in), so the reference's W . h
is h . W^T here; the output is the first 8 features of each point after
the last layer, (P, 8) float32.

  mlp_stack_bf16: h <- bf16(relu(h . W^T)), products summed in float32;
  mlp_stack_int8: h <- clip((h . W^T) >> 7, 0, 127), summed in int32.

Each wrapper launches csrc/mlp_stack.cu for CUDA tensors and counts the
launch in nerf_kernels.LAUNCHES; for CPU tensors it runs the plain version
beside it. The plain int8 version sums in float32, which is exact while
every partial sum stays below 2^24 (weights within [-24, 24] at W=256:
127 x 24 x 256 = 780,288), so it must equal the kernel bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import torch

from dfnet_tpu_torch.ops import nerf_kernels as nk

N_OUT = 8       # features written per point
# The bf16 stack against its plain version. Both round the same float32 sums
# to bf16 after every layer, so they differ only where the order of a sum
# moves it across a bf16 rounding midpoint, and downstream of such a flip.
# A wrong stack (sums kept in bf16, no bf16 round between layers, a 1%
# error) changes a large share of the outputs: BF16_DIFF_SHARE caps the
# share that may differ at all, and every output must stay within two bf16
# steps (BF16_RTOL) plus BF16_ATOL_RMS times the output's RMS (a flip
# next to a ReLU's zero). bench_int8_wide.check prints the readings these
# were set from: each sound run's share, and each faulty control's.
BF16_DIFF_SHARE = 0.01
BF16_RTOL = 2.0 ** -6
BF16_ATOL_RMS = 2.0 ** -3


def bf16_stack_agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Holds a bf16 stack's output against its plain version's:
    {"ok", "max_abs_err", "diff_share", "ratio"}, where ratio > 1 means an
    output beyond BF16_RTOL / BF16_ATOL_RMS."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    atol = BF16_ATOL_RMS * want.pow(2).mean().sqrt()
    ratio = float((err / (atol + BF16_RTOL * want.abs()).clamp_min(1e-30)).max())
    share = float((err > 0).float().mean())
    ok = bool(torch.isfinite(got).all()) and share <= BF16_DIFF_SHARE and ratio <= 1.0
    return dict(ok=ok, max_abs_err=float(err.max()), diff_share=share, ratio=ratio)


def mlp_stack_bf16_plain(x: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Plain version of mlp_stack_bf16: x (P, W) bf16, ws (D, W, W) bf16."""
    h = x.float()
    for w in ws:
        h = torch.relu(h @ w.float().t()).bfloat16().float()
    return h[:, :N_OUT].contiguous()


def mlp_stack_int8_plain(x: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Plain version of mlp_stack_int8: x (P, W) int8, ws (D, W, W) int8.
    floor(y / 128) is the arithmetic shift y >> 7."""
    h = x.float()
    for w in ws:
        h = torch.clamp(torch.floor((h @ w.float().t()) / 128.0), 0.0, 127.0)
    return h[:, :N_OUT].contiguous()


def _launch(name: str, x: torch.Tensor, ws: torch.Tensor, dtype) -> torch.Tensor:
    from dfnet_tpu_torch.ops import build

    if x.dim() != 2 or ws.dim() != 3:
        raise ValueError(f"{name}: want x (P, W) and ws (D, W, W)")
    P, W = x.shape
    D = ws.shape[0]
    if W < 16 or W % 16 or D < 1 or P >= 2 ** 31:
        raise ValueError(f"{name}: needs W a multiple of 16 and D >= 1: P={P} W={W} D={D}")
    nk._check("x", x, (P, W), dtype, x.device)
    nk._check("ws", ws, (D, W, W), dtype, x.device)
    # the kernel takes each weight k-blocked, (W, W) -> (W/16, W, 16), so
    # that every WMMA fragment starts 256-bit aligned (csrc/mlp_stack.cu)
    blocked = ws.reshape(D, W, W // 16, 16).permute(0, 2, 1, 3).contiguous()
    out = torch.empty((P, N_OUT), device=x.device, dtype=torch.float32)
    rc = build.load("mlp_stack", f"dfn_{name}")(x.data_ptr(), blocked.data_ptr(), P, W,
                                                D, out.data_ptr(), nk._stream(out))
    nk._raise_on(rc, name)
    nk.LAUNCHES[name] += 1
    return out


def mlp_stack_bf16(x: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """D layers h <- bf16(relu(h . W^T)) over x (P, W) bf16 with weights
    ws (D, W, W) bf16 -> (P, 8) float32."""
    if not nk._on_cuda(x):
        return mlp_stack_bf16_plain(x, ws)
    return _launch("mlp_stack_bf16", x, ws, torch.bfloat16)


def mlp_stack_int8(x: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """D layers h <- clip((h . W^T) >> 7, 0, 127) over x (P, W) int8 with
    weights ws (D, W, W) int8, int32 sums -> (P, 8) float32."""
    if not nk._on_cuda(x):
        return mlp_stack_int8_plain(x, ws)
    return _launch("mlp_stack_int8", x, ws, torch.int8)


def probe_inputs(dtype: str, W: int, P: int, D: int, device,
                 seed: int = 0) -> Sequence[torch.Tensor]:
    """The probe's data, with the reference script's distributions: int8
    x in [0, 64) and weights in [-4, 4); bf16 x ~ U[0, 0.5) and weights
    ~ N(0, 1/W). Drawn on `device` from a generator seeded there."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, device=device)
    if dtype == "int8":
        x = torch.randint(0, 64, (P, W), dtype=torch.int8, **kw)
        ws = torch.randint(-4, 4, (D, W, W), dtype=torch.int8, **kw)
    elif dtype == "bf16":
        x = (torch.rand((P, W), **kw) * 0.5).bfloat16()
        ws = (torch.randn((D, W, W), **kw) * W ** -0.5).bfloat16()
    else:
        raise ValueError(f"unknown probe dtype {dtype!r}")
    return x, ws
