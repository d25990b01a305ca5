"""Builds the CUDA kernels of `ops/csrc` at first use and loads them.

Each `csrc/<name>.cu` compiles with nvcc for sm_90a into its own shared
library with a plain C interface, loaded with ctypes (no PyTorch headers,
so a build takes seconds). Libraries go to `build/dfnet_tpu_torch/<hash>/`
beside the package, keyed on a hash of every source, the flags and the
nvcc version, so an edited source rebuilds and an unchanged one loads
from disk. `build_all()` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "dfnet_tpu_torch"
KERNEL_SOURCES = ("coarse_sigma", "fine_raw", "fine_composite", "raw_bwd", "proposal_z",
                  "mlp_stack")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signature of each entry point, by its name: `dfn_<source>` unless a
# source has several (mlp_stack.cu, raw_bwd.cu, and an occupancy entry)
SIGNATURES = {
    "dfn_coarse_sigma": [_P, _P, _I, _I, _F, _F, _F, _I, _P, _P, _P, _I, _I, _I, _I, _P,
                         _P],
    "dfn_coarse_sigma_occupancy": [_I, _I, _P, _P],
    "dfn_fine_raw": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "dfn_fine_raw_occupancy": [_I, _I, _P, _P],
    "dfn_fine_composite": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "dfn_fine_composite_occupancy": [_I, _I, _I, _I, _P, _P],
    "dfn_raw_bwd_stash": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                          _P, _P, _P, _I, _P],
    "dfn_raw_bwd_wgrad": [_P, _P, _P, _I, _L, _L, _I, _I, _P, _L, _P],
    "dfn_raw_bwd_reduce": [_P, _I, _L, _I, _I, _L, _I, _P, _P, _P, _I, _I, _I, _P, _P],
    "dfn_proposal_z": [_P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _F, _P, _P, _P, _I, _I,
                       _I, _I, _I, _P, _P],
    "dfn_proposal_z_occupancy": [_I, _I, _I, _I, _P, _P],
    "dfn_mlp_stack_bf16": [_P, _P, _I, _I, _I, _P, _P],
    "dfn_mlp_stack_int8": [_P, _P, _I, _I, _I, _P, _P],
    "dfn_mlp_stack_occupancy": [_I, _I, _P, _P],
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                           "with the CUDA toolkit")
    return path


def _build_dir() -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    ver = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    h.update(ver.encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def _start(name: str, out_dir: Path):
    """Start nvcc for csrc/<name>.cu unless its library exists; returns
    (process or None, library path, log path, temporary path)."""
    lib = out_dir / f"lib{name}.so"
    log = out_dir / f"{name}.log"
    if lib.exists():
        return None, lib, log, None
    tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, lib, log, tmp


def build_all(names: List[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Compile every named source in parallel (one nvcc each) and return
    the library paths. Raises RuntimeError with nvcc's output on failure."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {n: _start(n, out_dir) for n in names}
    errors = []
    for name, (proc, lib, log, tmp) in jobs.items():
        if proc is None:
            continue
        text, _ = proc.communicate()
        # per process, then renamed, like the library: ranks of a mesh may
        # build the same source at once
        log_tmp = out_dir / f"{name}.{os.getpid()}.log"
        log_tmp.write_text(text)
        os.replace(log_tmp, log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{text}")
            continue
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: jobs[n][1] for n in names}


def ptxas_report(name: str) -> str:
    """nvcc's -Xptxas -v output (registers, shared memory, spills) from
    the build of csrc/<name>.cu; empty when the library came from disk."""
    log = _build_dir() / f"{name}.log"
    return log.read_text() if log.exists() else ""


def load(name: str, entry: str = ""):
    """The C entry point `entry` (default `dfn_<name>`) of csrc/<name>.cu,
    building the library if needed."""
    with _lock:
        if name not in _loaded:
            path = build_all([name])[name]
            _loaded[name] = ctypes.CDLL(str(path))
        lib = _loaded[name]
    entry = entry or f"dfn_{name}"
    fn = getattr(lib, entry)
    fn.argtypes = SIGNATURES[entry]
    fn.restype = ctypes.c_int
    return fn
