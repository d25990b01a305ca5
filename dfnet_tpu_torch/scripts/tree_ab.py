"""Another tree's sweep kernels, and its stage-1 step, timed beside this
tree's on one card in one run.

    python -m dfnet_tpu_torch.scripts.tree_ab kernels --parent TREE [--reps 7]
    python -m dfnet_tpu_torch.scripts.tree_ab step --parent TREE
    python -m dfnet_tpu_torch.scripts.tree_ab culled --parent TREE

TREE is the root of another checkout of the repo (for example `git archive`
of the parent commit unpacked into a gitignored directory such as proof/).

kernels: builds TREE's SOURCES with ops/build.py's nvcc flags into
build/tree_ab/ (the C entry points must be this tree's, but for a
dfn_fine_composite or dfn_proposal_z from before the wrapper chose R: a
shim drops R; and for an mlp_stack that took k-blocked weights: a shim
passes a k-blocked copy), and this tree's through ops/build.py. At each
of SHAPES (random nets from a seed: the shipped fine net D=8 skip 4,
F=10, at sorted uniform z; the proposal D=2 W=64 F=4 and the coarse net
D=8 W=128 F=10 for coarse_sigma_t, the proposal net for proposal_z_rows
at the mono path's S=64, S_f=128; the probe's stacks at 2^21 points, D=6,
bf16 on the probe's data, int8 on weights that keep it non-zero) it calls
this tree's wrapper with each tree's library in turn (parent, this, this,
parent; each reading a CUDA-event median of --reps calls) and prints one
JSON line a shape and kernel: each tree's median of its two readings, the
readings, whether the two trees' outputs are bit-equal, and each tree's
largest error against the plain version.

step: runs chip_smoke.py's phase_train (20 epochs of the shipped config
through the CLI, then step_breakdown) from each tree's root in its own
process, in turns parent, this, this, parent, and prints one JSON line of
each run's steps/s, step breakdown and val PSNR.

culled: the same turns of each tree's stage-1 CLI at the shipped config
under the culled train schedule (--train_cull_q 2e-3 --train_fine_total
32), epochs 0-10: steps/s over epochs 1-10 and the val PSNR.

Both print the card's name and power limit first. Need a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from dfnet_tpu_torch.models.embedder import get_embedder
from dfnet_tpu_torch.models.nerfw import NeRFWConfig, init_nerfw_params, init_sigma_mlp
from dfnet_tpu_torch.ops import build
from dfnet_tpu_torch.ops import mlp_stack as ms
from dfnet_tpu_torch.ops import nerf_kernels as nk
from dfnet_tpu_torch.scripts import bench_int8_wide as probe
from dfnet_tpu_torch.utils.timing import cuda_ms

ROOT = Path(__file__).resolve().parents[2]
OUT = build.BUILD_ROOT.parent / "tree_ab"
SOURCES = ("fine_raw", "raw_bwd", "fine_composite", "coarse_sigma", "proposal_z", "mlp_stack")
ENTRY = {"raw_bwd": "dfn_raw_bwd_stash", "mlp_stack": "dfn_mlp_stack_bf16"}   # any one entry
# (name, W, static, rays, samples): render chunks and one train step's sweeps
# (fine_raw_t; raw_bwd_t on the train shapes), the culled and mono
# composites (fine_composite_t), and the placement sweeps (coarse_sigma_t,
# whose net the name gives)
SHAPES = [("render", 128, False, 16384, 128), ("render", 256, False, 16384, 128),
          ("train-fine", 128, False, 1536, 128), ("train-static", 128, True, 1536, 64),
          ("train-fine", 256, False, 1536, 128), ("train-static", 256, True, 1536, 64),
          ("composite-culled", 128, False, 16384, 24),
          ("composite-mono", 128, False, 16384, 128),
          ("composite-culled", 256, False, 16384, 24),
          ("composite-mono", 256, False, 16384, 128),
          ("sigma-proposal", 64, False, 16384, 64), ("sigma-coarse-net", 128, False, 16384, 64),
          ("sampler-mono", 64, False, 16384, 64),
          ("stack-bf16", 256, False, 1 << 21, 6), ("stack-int8", 256, False, 1 << 21, 6),
          ("stack-bf16", 128, False, 1 << 21, 6), ("stack-int8", 128, False, 1 << 21, 6)]
SAMPLER_S_F = 128            # proposal_z_rows' fine samples a ray on the mono path
NEAR, FAR = 2.0, 6.0
RESULT = "tree_ab result: "


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


class _DropR:
    """TREE's library when its `entry` chose R itself (no R argument, which
    this tree's wrapper passes at index `at`): the wrapper's call, R
    dropped."""

    def __init__(self, lib, entry, at, argtypes):
        self._lib, self._entry, self._at, self._argtypes = lib, entry, at, argtypes

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name != self._entry:
            return fn
        fn.argtypes, fn.restype = self._argtypes, ctypes.c_int
        return lambda *a: fn(*a[:self._at], *a[self._at + 1:])


class _KBlocked:
    """TREE's mlp_stack library when its kernels took each weight k-blocked,
    (D, W, W) -> (D, W/16, W, 16): the wrapper's call, its weight pointer
    swapped for a k-blocked copy made beforehand by `block(ws)`."""

    def __init__(self, lib):
        self._lib, self._copies = lib, {}

    def block(self, ws: torch.Tensor):
        D, W, _ = ws.shape
        self._copies[ws.data_ptr()] = ws.reshape(D, W, W // 16, 16).permute(0, 2, 1, 3).contiguous()

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if not name.startswith("dfn_mlp_stack_"):
            return fn
        fn.argtypes, fn.restype = build.SIGNATURES[name], ctypes.c_int
        return lambda x, w, *a: fn(x, self._copies[w].data_ptr(), *a)


def tree_signatures(tree: Path) -> dict:
    """TREE's ops/build.py SIGNATURES."""
    spec = importlib.util.spec_from_file_location(
        "tree_ab_build", tree / "dfnet_tpu_torch" / "ops" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SIGNATURES


def build_parent(tree: Path) -> dict:
    """{source: ctypes library} of TREE's kernels, built in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for n in SOURCES:
        lib = OUT / f"lib{n}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
               str(tree / "dfnet_tpu_torch" / "ops" / "csrc" / f"{n}.cu")]
        jobs[n] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    libs = {}
    for n, (lib, proc) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tree}'s {n}.cu:\n{text}")
        libs[n] = ctypes.CDLL(str(lib))
    sigs = tree_signatures(tree)
    for n, at in (("fine_composite", 13), ("proposal_z", 18)):
        sig = sigs[f"dfn_{n}"]
        if len(sig) == len(build.SIGNATURES[f"dfn_{n}"]) - 1:
            libs[n] = _DropR(libs[n], f"dfn_{n}", at, sig)
    if "kblocked(" in (tree / "dfnet_tpu_torch" / "ops" / "csrc" / "mlp_stack.cu").read_text():
        libs["mlp_stack"] = _KBlocked(libs["mlp_stack"])
    return libs


def inputs(W: int, static: bool, N: int, S: int, device, seed: int = 0):
    cfg = NeRFWConfig(D=8, W=W, skips=(4,), encode_appearance=True, encode_transient=True)
    params = init_nerfw_params(torch.Generator().manual_seed(seed), cfg, device)
    emb = get_embedder(10)
    packed = (nk.pack_static_t if static else nk.pack_fine_t)(params, cfg, emb)
    packed = {k: v.detach().contiguous() for k, v in packed.items()}
    spec = nk.spec_of(cfg, emb, fine=not static, static=static)
    rng = np.random.default_rng(seed + 1)
    ro = rng.normal(size=(N, 3)).astype(np.float32) * 0.3
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(NEAR, FAR, (N, S)), -1).astype(np.float32)
    dpt = rng.normal(size=(N, spec.Wd)).astype(np.float32)
    g = rng.uniform(size=(spec.n_raw, N, S)).astype(np.float32)
    t = lambda a: torch.tensor(a, device=device)
    return (packed, t(ro), t(rd), t(z), t(dpt), spec), t(g)


def sigma_inputs(shape: str, N: int, S: int, device, seed: int = 0):
    """coarse_sigma_t's arguments on the proposal net (D=2, W=64, F=4) or the
    coarse net (D=8, W=128, skip 4, F=10), from a seed."""
    D, W, skips, F = (2, 64, (), 4) if shape == "sigma-proposal" else (8, 128, (4,), 10)
    cfg = NeRFWConfig(D=D, W=W, skips=skips, in_xyz=6 * F + 3)
    params = init_sigma_mlp(torch.Generator().manual_seed(seed), cfg, device)
    emb = get_embedder(F)
    packed = {k: v.detach().contiguous() for k, v in nk.pack_coarse_t(params, cfg, emb).items()}
    rng = np.random.default_rng(seed + 1)
    ro = rng.normal(size=(N, 3)).astype(np.float32) * 0.3
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    t = lambda a: torch.tensor(a, device=device)
    return (packed, t(ro), t(rd), nk.spec_of(cfg, emb, fine=False), S, NEAR, FAR, False)


def calls_at(shape: str, W: int, static: bool, N: int, S: int, device, parent) -> dict:
    """{kernel: (call, plain output)} of one shape (for the stacks, N is
    the point count and S the depth)."""
    if shape.startswith("stack"):
        dtype = shape.split("-")[1]
        x, ws = ms.probe_inputs(dtype, W, N, S, device)
        if dtype == "int8":               # the probe's int8 weights zero every output
            ws = probe.alive_int8_weights(ws.shape, device)
        if isinstance(parent.get("mlp_stack"), _KBlocked):
            parent["mlp_stack"].block(ws)
        kern = ms.mlp_stack_bf16 if dtype == "bf16" else ms.mlp_stack_int8
        plain = ms.mlp_stack_bf16_plain if dtype == "bf16" else ms.mlp_stack_int8_plain
        return {f"mlp_stack_{dtype}": (lambda: kern(x, ws), plain(x, ws))}
    if shape.startswith("sigma"):
        a = sigma_inputs(shape, N, S, device)
        return {"coarse_sigma_t": (lambda: nk.coarse_sigma_t(*a), nk.coarse_sigma_plain(*a))}
    if shape.startswith("sampler"):
        a = sigma_inputs("sigma-proposal", N, S, device)
        a = (*a[:5], SAMPLER_S_F, NEAR, FAR, S / SAMPLER_S_F)
        return {"proposal_z_rows": (lambda: nk.proposal_z_rows(*a), nk.proposal_z_plain(*a))}
    sweep, g = inputs(W, static, N, S, device)
    if shape.startswith("composite"):
        return {"fine_composite_t": (lambda: nk.fine_composite_t(*sweep),
                                     nk.fine_composite_plain(*sweep))}
    calls = {"fine_raw_t": (lambda: nk.fine_raw_t(*sweep), nk.fine_raw_plain(*sweep))}
    if shape.startswith("train"):
        calls["raw_bwd_t"] = (lambda: nk.raw_bwd_t(*sweep[:5], g, sweep[5]),
                              nk.raw_bwd_plain(*sweep[:5], g, sweep[5]))
    return calls


def max_err(got, want) -> float:
    """Largest |got - want| over the outputs, each over its own largest
    |want| (for raw_bwd_t's three gradients)."""
    if torch.is_tensor(got):
        got, want = (got,), (want,)
    return max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
               for a, b in zip(got, want))


def run_kernels(parent: Path, reps: int) -> int:
    device = torch.device("cuda")
    theirs = build_parent(parent)
    build.build_all(list(SOURCES))
    for n in SOURCES:
        build.load(n, ENTRY.get(n, ""))
    ours = {n: build._loaded[n] for n in SOURCES}

    def use(libs):
        # the wrappers look their library up by source name on every call
        with build._lock:
            build._loaded.update(libs)

    trees = {"parent": theirs, "this": ours}
    for shape, W, static, N, S in SHAPES:
        with torch.no_grad():
            calls = calls_at(shape, W, static, N, S, device, theirs)
        for name, (fn, want) in calls.items():
            outs, ms = {}, {t: [] for t in trees}
            with torch.no_grad():
                for t in ("parent", "this", "this", "parent"):
                    use(trees[t])
                    outs.setdefault(t, fn())
                    ms[t].append(cuda_ms(fn, reps=reps))
            a, b = outs["parent"], outs["this"]
            same = (torch.equal(a, b) if torch.is_tensor(a)
                    else all(torch.equal(x, y) for x, y in zip(a, b)))
            print(json.dumps(dict(
                kernel=name, shape=shape, W=W, static=static, N=N, S=S,
                ms={t: float(np.median(v)) for t, v in ms.items()}, readings=ms,
                bits_equal=same, max_rel_err={t: max_err(o, want) for t, o in outs.items()})),
                flush=True)
            del outs
        use(ours)
        del calls
        torch.cuda.empty_cache()
    return 0


_STEP = f"""
import json, torch, chip_smoke as c
r = c.phase_train(torch.device("cuda"))
print({RESULT!r} + json.dumps({{k: r[k] for k in ("steps_per_s", "val_psnr", "breakdown")}}),
      flush=True)
"""


# the stage-1 CLI at the shipped config plus argv for epochs 0-10: steps/s
# over epochs 1-10 (host clock around each epoch, which ends in a fetch of
# its loss) and the val PSNR
_CLI = f"""
import json, sys, tempfile, time
from dfnet_tpu_torch.cli.nerf import train
from dfnet_tpu_torch.training.nerf_trainer import NeRFTrainer
secs, orig = [], NeRFTrainer.train_epoch
def timed(self, epoch):
    t0 = time.perf_counter()
    out = orig(self, epoch)
    secs.append((len(self.scene.train), time.perf_counter() - t0))
    return out
NeRFTrainer.train_epoch = timed
with tempfile.TemporaryDirectory() as base:
    psnr = train(["--dataset_type", "synthetic", "--NeRFH", "--encode_hist", "--basedir",
                  base, "--expname", "nerfh", "--epochs", "10", "--i_weights", "10",
                  "--i_testset", "10", *sys.argv[1:]])
steady = secs[1:]
print({RESULT!r} + json.dumps({{"steps_per_s": sum(n for n, _ in steady)
                                / sum(t for _, t in steady), "val_psnr": psnr}}), flush=True)
"""
CULLED_FLAGS = ["--train_cull_q", "2e-3", "--train_fine_total", "32"]


def run_step(parent: Path, what: str) -> int:
    runs = []
    cmd = {"step": ["-c", _STEP], "culled": ["-c", _CLI, *CULLED_FLAGS]}[what]
    for name, root in (("parent", parent), ("this", ROOT), ("this", ROOT),
                       ("parent", parent)):
        proc = subprocess.run([sys.executable, *cmd], cwd=root, capture_output=True,
                              text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(RESULT)]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            raise RuntimeError(f"{what} of {root} failed (exit {proc.returncode})")
        runs.append(dict(tree=name, **json.loads(lines[-1][len(RESULT):])))
        print(json.dumps(runs[-1]), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("kernels", "step", "culled"))
    ap.add_argument("--parent", type=Path, required=True, help="another tree's root")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tree_ab: no CUDA device", file=sys.stderr)
        return 1
    print(f"[card] {card()}", flush=True)
    parent = args.parent.resolve()
    return (run_kernels(parent, args.reps) if args.what == "kernels"
            else run_step(parent, args.what))


if __name__ == "__main__":
    sys.exit(main())
