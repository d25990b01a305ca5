"""Digests of the machine code (SASS) of the port's CUDA sources, to show
whether two trees compile a kernel to the same instructions.

    python -m dfnet_tpu_torch.scripts.sass_digest CSRC [CSRC ...] [--sources a,b]

Builds each named source (default: all of ops/build.py's KERNEL_SOURCES)
of each CSRC directory (a tree's dfnet_tpu_torch/ops/csrc) with
ops/build.py's nvcc flags into build/sass_digest/, disassembles it with
cuobjdump -sass and prints one JSON line: for each tree and source, a
sha256 of each kernel's instructions (addresses, encodings and comments
dropped; symbol names, which carry a per-file hash for anonymous
namespaces, masked) keyed by the kernel's name with that hash masked too,
and a digest of the whole library's instructions in order (names left
out, so a device function that is not inlined counts by its code). With
two or more trees it also lists, per source, whether every tree's
library digest equals the first tree's. Needs nvcc and cuobjdump (CUDA toolkit).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

from dfnet_tpu_torch.ops import build

OUT = build.BUILD_ROOT.parent / "sass_digest"
_ANON = re.compile(r"\d*_GLOBAL__N__\w+?_cu_[0-9a-f]{8}")
_SYM = re.compile(r"\b_Z\w+")


def cuobjdump() -> str:
    return os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")


def functions(sass: str) -> list:
    """[(kernel name with the anonymous-namespace hash masked, normalised
    instruction lines)] in the order cuobjdump prints them."""
    out, name, lines = [], None, []
    for raw in sass.splitlines():
        m = re.search(r"Function : (\S+)", raw)
        if m:
            if name is not None:
                out.append((name, lines))
            name, lines = _ANON.sub("<anon>", m.group(1)), []
            continue
        if name is None:
            continue
        text = re.sub(r"/\*.*?\*/", "", raw).strip()
        if not text or text.startswith("."):
            continue
        lines.append(_SYM.sub("<sym>", _ANON.sub("<anon>", text)))
    if name is not None:
        out.append((name, lines))
    return out


def digest(lines) -> str:
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("csrc", nargs="+", type=Path)
    ap.add_argument("--sources", default=",".join(build.KERNEL_SOURCES))
    args = ap.parse_args(argv)
    names = args.sources.split(",")
    procs = {}
    for t, csrc in enumerate(args.csrc):
        d = OUT / f"tree{t}"
        d.mkdir(parents=True, exist_ok=True)
        for n in names:
            lib = d / f"lib{n}.so"
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(csrc / f"{n}.cu")]
            procs[t, n] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    result = {}
    for (t, n), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {args.csrc[t]}/{n}.cu:\n{log}")
        sass = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        fns = functions(sass)
        result.setdefault(str(args.csrc[t]), {})[n] = dict(
            library=digest([digest(v) for _, v in fns]),
            kernels={k: digest(v) for k, v in fns})
    trees = [str(c) for c in args.csrc]
    same = {n: all(result[t][n]["library"] == result[trees[0]][n]["library"]
                   for t in trees[1:]) for n in names} if len(trees) > 1 else {}
    print(json.dumps(dict(digests=result, same_as_first=same)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
