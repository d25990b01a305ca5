"""The layer-stack probe's kernels: D stacked W x W layers in bf16 or int8.

Port of scripts/bench_int8_wide.py::build (Pallas kernels _kernel_bf16
and _kernel_int8), a microbenchmark of the marginal cost of one MLP layer
(dfnet_tpu_torch/scripts/bench_int8_wide.py drives it). Points-major:
x is (P, W) and each weight (W, W) is (out, in), so the reference's W . h
is h . W^T here; the output is the first 8 features of each point after
the last layer, (P, 8) float32.

  mlp_stack_bf16: h <- bf16(relu(h . W^T)), products summed in float32;
  mlp_stack_int8: h <- clip((h . W^T) >> 7, 0, 127), summed in int32.

Each wrapper launches csrc/mlp_stack.cu (warpgroup MMA over TMA-fed
shared memory) for CUDA tensors and counts the launch in
nerf_kernels.LAUNCHES; for CPU tensors it runs the plain version beside
it. The kernel is built for the widths in WIDTHS; any other W raises. The
plain int8 version sums in float32, which is exact while every partial
sum stays below 2^24 (weights within [-24, 24] at W=256: 127 x 24 x 256 =
780,288), so it must equal the kernel bit for bit.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from dfnet_tpu_torch.ops import nerf_kernels as nk

N_OUT = 8       # features written per point
WIDTHS = (64, 128, 192, 256)   # the widths csrc/mlp_stack.cu is built for
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


# csrc/mlp_stack.cu's shared memory (Geo), mirrored so that the GPU test can
# hold the C occupancy entry to it and the CPU test can bound the tiles
_ROWS, _PANEL, _ALIGN, _BAR_BYTES, _MAX_STAGES = 64, 128, 1024, 256, 8
_SMEM_LIMIT = 232448            # dynamic shared bytes a block may ask for


def _esize(dtype: str) -> int:
    return {"bf16": 2, "int8": 1}[dtype]


def a_tile_bytes(dtype: str, W: int) -> int:
    """Bytes of one consumer warpgroup's activation tile: 64 rows in
    128-byte panels, K padded up to a whole panel."""
    return -(-W * _esize(dtype) // _PANEL) * _ROWS * _PANEL


def mlp_stack_geometry(dtype: str, W: int) -> dict:
    """The kernel's block at a type and width: consumer warpgroups (ncw;
    64 rows each, so 64 ncw rows a tile), weight-ring stages and shared
    bytes a block."""
    ncw = 4 if W <= 128 else 2
    a = a_tile_bytes(dtype, W)
    stage = W * _PANEL
    stages = min(_MAX_STAGES, (_SMEM_LIMIT - _ALIGN - _BAR_BYTES - ncw * a) // stage)
    return dict(ncw=ncw, rows=_ROWS * ncw, stages=stages,
                smem_bytes=_ALIGN + ncw * a + stages * stage + _BAR_BYTES)


def mlp_stack_occupancy(dtype: str, W: int) -> Tuple[int, int]:
    """(blocks an SM, shared memory bytes a block) of the kernel of a type
    and width, from the CUDA occupancy calculator."""
    if W not in WIDTHS:
        raise ValueError(f"mlp_stack takes W in {WIDTHS}, got {W}")
    return nk._occupancy("mlp_stack", int(dtype == "int8"), W)


def _launch(name: str, x: torch.Tensor, ws: torch.Tensor, dtype) -> torch.Tensor:
    from dfnet_tpu_torch.ops import build

    if x.dim() != 2 or ws.dim() != 3:
        raise ValueError(f"{name}: want x (P, W) and ws (D, W, W)")
    P, W = x.shape
    D = ws.shape[0]
    if W not in WIDTHS or D < 1 or P >= 2 ** 31:
        raise ValueError(f"{name} takes W in {WIDTHS} and D >= 1: P={P} W={W} D={D}")
    nk._check("x", x, (P, W), dtype, x.device)
    nk._check("ws", ws, (D, W, W), dtype, x.device)
    if x.data_ptr() % 16 or ws.data_ptr() % 16:
        raise ValueError(f"{name}: TMA reads x and ws from 16-byte aligned addresses")
    out = torch.empty((P, N_OUT), device=x.device, dtype=torch.float32)
    if P == 0:
        return out
    rc = build.load("mlp_stack", f"dfn_{name}")(x.data_ptr(), ws.data_ptr(), P, W, D,
                                                out.data_ptr(), nk._stream(out))
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
