"""The yardstick: the H100's peaks and the operations and bytes of each
NeRF sweep kernel, worked out from shapes alone.

Copied from chip_smoke.py (`work`, `bound`, `nerf_point_flops` and the
peak constants) and frozen here, so that a change to the program cannot
change what its kernels are measured against. The kernels' shapes are
given as plain numbers (`Sweep`), not as the program's spec objects.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_BF16 = 989e12          # FLOP/s on the tensor cores
PEAK_TF32 = 495e12          # FLOP/s on the tensor cores
PEAK_F32 = 67e12            # FLOP/s on the CUDA cores
PEAK_INT8 = 1979e12         # OP/s on the tensor cores
HBM_BYTES_S = 3.35e12       # bytes/s of HBM3

N_RAW = 9       # rows of a fine sweep's output: rgb, sigma, t-rgb, t-sigma, t-beta
N_STATIC = 4    # rows of a static sweep's output: rgb, sigma


@dataclass(frozen=True)
class Sweep:
    """One launch of a NeRF sweep kernel: N rays of S samples through a
    net of depth D and width W (skip layer `skip`, -1 for none; F PE
    frequencies). kind: "sigma" (placement sweep), "static" (the coarse
    net's train sweep) or "fine" (the NeRF-W net)."""
    kind: str
    N: int
    S: int
    D: int
    W: int
    skip: int
    F: int

    @property
    def K0(self) -> int:
        return -(-(6 * self.F + 3) // 16) * 16

    @property
    def n_raw(self) -> int:
        return N_RAW if self.kind == "fine" else N_STATIC

    @property
    def Wd(self) -> int:
        return self.W if self.kind == "fine" else self.W // 2


def packed_numel(s: Sweep) -> Tuple[int, int]:
    """(bf16 weights, float32 biases) of the kernel's packed net."""
    W, K0, half = s.W, s.K0, s.W // 2
    w = W * K0
    for i in range(1, s.D):
        w += W * K0 + W * W if i == s.skip else W * W
    b = s.D * W
    if s.kind == "fine":
        w += W * W + 3 * half * half + N_RAW * W
        b += W + 3 * half + N_RAW
    elif s.kind == "static":
        w += half * W + N_STATIC * W
        b += half + N_STATIC
    else:
        w += W
        b += 1
    return w, b


def work(kernel: str, s: Sweep) -> Tuple[List[Tuple[float, float]], float]:
    """([(operations, peak rate of their type)], bytes) that `kernel` must
    do and move for sweep `s`: matmul flops at the real widths on the
    tensor cores, each input read once and each output written once."""
    N, S, W, half, in0 = s.N, s.S, s.W, s.W // 2, 6 * s.F + 3
    per = in0 * W + (s.D - 1) * W * W + (in0 * W if s.skip > 0 else 0)
    nw, nb = packed_numel(s)
    wbytes = 2 * nw + 4 * nb
    if kernel == "coarse_sigma_t":
        return [(2 * (per + W) * N * S, PEAK_BF16)], 24 * N + wbytes + 4 * N * S
    if s.kind == "static":
        per += half * W + 3 * half + W                 # dir half of w_dt, heads
    else:
        per += W * W + 3 * half * half + 8 * half + W  # w_dt, transient, heads
    inputs = 24 * N + 4 * N * S + 4 * N * s.Wd + wbytes
    if kernel == "raw_bwd_t":
        # recompute + input grads + weight grads; no input grad into x0
        macs = 3 * per - in0 * W * (2 if s.skip > 0 else 1)
        return ([(2 * macs * N * S, PEAK_BF16)],
                inputs + 4 * s.n_raw * N * S + wbytes + 4 * N * s.Wd)
    out = {"fine_raw_t": 4 * s.n_raw * N * S, "fine_composite_t": 32 * N}[kernel]
    return [(2 * per * N * S, PEAK_BF16)], inputs + out


def bound_ms(kernel: str, s: Sweep) -> float:
    """The least time the card could take: the larger of the operations'
    time at their type's peak and the bytes' time at the HBM rate."""
    terms, nbytes = work(kernel, s)
    return max(max(n / peak for n, peak in terms), nbytes / HBM_BYTES_S) * 1e3


def point_flops(D: int, W: int, skip: int, in_xyz: int, in_dir: int = 0,
                in_a: int = 0, in_t: int = 0, kind: str = "fine") -> int:
    """Matmul FLOPs a sample point of one NeRF-W net's forward
    (chip_smoke.py's `nerf_point_flops` on the shapes of the params tree):
    every layer's rows by columns, but only the W point rows of `dir` and
    `trans_0` (their direction and embedding rows are per ray). kind
    "sigma" counts the trunk and the sigma head, "static" adds
    xyz_final, dir and the rgb head, "fine" also the transient chain."""
    half = W // 2
    flops = sum((in_xyz if i == 0 else (W + in_xyz if i == skip else W)) * W
                for i in range(D))
    flops += W * 1                                       # static_sigma
    if kind in ("static", "fine"):
        flops += W * W + W * half + half * 3             # xyz_final, dir, static_rgb
    if kind == "fine":
        flops += W * half + 3 * half * half + half * 5   # trans_0..3, heads
    return 2 * flops
