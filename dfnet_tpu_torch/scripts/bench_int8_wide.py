"""Layer-stack probe: the marginal cost of one W x W MLP layer on the card,
int8 with shift requantisation against bf16 (port of
scripts/bench_int8_wide.py).

A D-layer stack (ops/mlp_stack.py, one kernel launch) is timed at D=2 and
D=6 with CUDA events; the difference over the four extra layers is the
marginal cost of a layer. It is reported in ms a layer for P points and as
TFLOP/s (bf16) or TOP/s (int8), beside the card's dense peaks (989 TFLOP/s
bf16, 1,979 TOP/s int8), with the int8/bf16 ratio of the marginals. Before
timing, each kernel is held against its plain version: int8 exactly, bf16
under ops/mlp_stack.py's bf16_stack_agreement, which must also reject each
of CONTROLS (stacks with a known fault) on the same data.

    python -m dfnet_tpu_torch.scripts.bench_int8_wide [--width 256] [--points 2097152]

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Dict, List, Optional

import torch

from dfnet_tpu_torch.ops import mlp_stack as ms
from dfnet_tpu_torch.utils.timing import cuda_ms

DEPTHS = (2, 6)
DTYPES = ("bf16", "int8")
PEAK = {"bf16": 989e12, "int8": 1979e12}    # H100 SXM dense, data sheet
ALIVE_INT8 = 24
KERNEL = {"bf16": ms.mlp_stack_bf16, "int8": ms.mlp_stack_int8}
PLAIN = {"bf16": ms.mlp_stack_bf16_plain, "int8": ms.mlp_stack_int8_plain}


def _bf16_sums(x: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """The bf16 stack with its running sums kept in bf16 (rounded after each
    16-wide k step, as a bf16 accumulator would)."""
    h = x.float()
    for w in ws:
        acc = torch.zeros((h.shape[0], w.shape[0]), device=h.device)
        for k in range(0, h.shape[1], 16):
            acc = (acc + h[:, k:k + 16] @ w[:, k:k + 16].float().t()).bfloat16().float()
        h = torch.relu(acc).bfloat16().float()
    return h[:, :ms.N_OUT].contiguous()


def _no_mid_round(x: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """The bf16 stack rounded to bf16 only after its last layer."""
    h = x.float()
    for w in ws:
        h = torch.relu(h @ w.float().t())
    return h[:, :ms.N_OUT].bfloat16().float()


def alive_int8_weights(shape, device) -> torch.Tensor:
    """int8 weights from [-ALIVE_INT8, ALIVE_INT8], seeded. The probe's own
    weights (mean -0.5) send every output to zero by the second layer, so
    an int8 check on them compares zeros; these keep a share of the
    outputs non-zero through D=6 at W=128 and 256, and every partial sum
    below 2^24 (127 x 24 x 256), where the plain version is exact."""
    gen = torch.Generator(device=device).manual_seed(1)
    return torch.randint(-ALIVE_INT8, ALIVE_INT8 + 1, shape, generator=gen, device=device,
                         dtype=torch.int8)


# bf16 stacks with a known fault: the agreement rule must reject each
CONTROLS = {
    "bf16 sums": _bf16_sums,
    "no bf16 round between layers": _no_mid_round,
    "1% off": lambda x, ws: (ms.mlp_stack_bf16_plain(x, ws) * 1.01).bfloat16().float(),
}


def check(W: int, P: int, device) -> Dict:
    """Each kernel against its plain version at every depth, on the probe's
    data and, for int8, also on alive_int8_weights (whose outputs must not
    all be zero). int8 must be equal; bf16 must pass
    bf16_stack_agreement, which must reject each of CONTROLS. Raises
    AssertionError otherwise; returns {dtype: {D: {"max_abs_err",
    "plain_ms", ...}}}. The plain int8 version sums in float32 and is exact
    only without TF32."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("turn TF32 matmuls off: the plain int8 stack must be exact")
    out = {}
    for dtype in DTYPES:
        x, ws = ms.probe_inputs(dtype, W, P, max(DEPTHS), device)
        sets = [ws]
        if dtype == "int8":
            sets.append(alive_int8_weights(ws.shape, device))
        out[dtype] = {}
        for D in DEPTHS:
            row = {}
            for i, w in enumerate(sets):
                got = KERNEL[dtype](x, w[:D])
                torch.cuda.synchronize()
                want = PLAIN[dtype](x, w[:D])
                if dtype == "int8":
                    if not torch.equal(got, want):
                        raise AssertionError(f"int8 W={W} D={D}: kernel != plain")
                    share = float((want > 0).float().mean())
                    if i == 1 and share == 0:
                        raise AssertionError(f"int8 W={W} D={D}: the alive weights' "
                                             "outputs are all zero")
                    row["max_abs_err"] = 0.0
                    row[f"nonzero_share_{'probe' if i == 0 else 'alive'}"] = share
                    continue
                agree = ms.bf16_stack_agreement(got, want)
                if not agree["ok"]:
                    raise AssertionError(f"bf16 W={W} D={D}: kernel disagrees: {agree}")
                row.update(agree)
                row["controls"] = {}
                for name, control in CONTROLS.items():
                    c = ms.bf16_stack_agreement(control(x, w[:D]), want)
                    if c["ok"]:
                        raise AssertionError(f"bf16 W={W} D={D}: the agreement rule "
                                             f"accepts the control {name!r}: {c}")
                    row["controls"][name] = {k: c[k] for k in ("diff_share", "ratio")}
            row["plain_ms"] = cuda_ms(lambda: PLAIN[dtype](x, ws[:D]), reps=3, warmup=1)
            out[dtype][D] = row
            print(f"[probe] check {dtype} W={W} D={D}: "
                  f"{json.dumps({k: v for k, v in row.items() if k != 'ok'})}", flush=True)
    return out


def run(W: int, P: int, device, reps: int = 10) -> Dict:
    """Times each kernel at every depth; returns {dtype: {"ms": {D: ms},
    "marginal_ms", "rate"}, "ratio": int8/bf16 marginal} and prints the
    reference script's lines."""
    res: Dict = {}
    for dtype in DTYPES:
        x, ws = ms.probe_inputs(dtype, W, P, max(DEPTHS), device)
        times = {D: cuda_ms(lambda: KERNEL[dtype](x, ws[:D]), reps) for D in DEPTHS}
        for D, t in times.items():
            print(f"{dtype} W={W} D={D}: {t:.3f} ms", flush=True)
        lo, hi = min(DEPTHS), max(DEPTHS)
        marg = (times[hi] - times[lo]) / (hi - lo)
        rate = 2 * W * W * P / (marg * 1e-3) if marg > 0 else float("inf")
        unit = "TOPS" if dtype == "int8" else "TFLOPS"
        print(f"{dtype} W={W}: marginal {marg:.4f} ms/layer per {P} pts "
              f"({rate / 1e12:.0f} {unit}; dense peak {PEAK[dtype] / 1e12:.0f})",
              flush=True)
        res[dtype] = {"ms": times, "marginal_ms": marg, "rate": rate}
    res["ratio"] = res["int8"]["marginal_ms"] / res["bf16"]["marginal_ms"]
    print(f"int8/bf16 marginal ratio: {res['ratio']:.3f} "
          f"({'int8 WINS' if res['ratio'] < 1 else 'bf16 wins'})", flush=True)
    return res


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--points", type=int, default=2 * 1024 * 1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_int8_wide: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[card] {smi.stdout.strip() or torch.cuda.get_device_name(0)}", flush=True)
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    check(args.width, args.points, device)
    run(args.width, args.points, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
