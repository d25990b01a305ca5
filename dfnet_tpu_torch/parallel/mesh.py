"""Data-parallel mesh over torch.distributed (port of
dfnet_tpu/parallel/mesh.py).

The JAX package's one multi-device construct is a 1-D 'data' mesh: ray
batches (stages 1 and 3) and image batches (stage 2) split along their
leading axis, params replicated, gradients averaged. Here a mesh of n is n
processes, one rank each, spawned by `launch`:

  - `--device cuda`: one rank a GPU on `cuda:<rank>` over NCCL;
  - `--device cpu`: n CPU processes over gloo (the analog of JAX's virtual
    CPU devices), any n;
  - `share_device=True` (a function argument, not a CLI flag): n ranks on
    `cuda:0` over gloo, since NCCL refuses two ranks on one GPU. It is the
    only way to run the path on a one-GPU machine.

Inside a rank the helpers below read the default process group; outside
one (no mesh) they are the identity, so the single-device path does not
change. Each rank runs the same program on the same data and random draws
(every rank draws what one device would, render/sampling.py::RowShard),
and keeps its rows of the sharded work.
"""

from __future__ import annotations

import datetime
import os
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A data mesh of `size` ranks on `device_type` ("cuda" or "cpu")."""
    size: int
    device_type: str = "cuda"
    share_device: bool = False

    @property
    def backend(self) -> str:
        return "nccl" if self.device_type == "cuda" and not self.share_device else "gloo"

    def device(self, rank: Optional[int] = None) -> torch.device:
        """The device of `rank` (default: this process's rank)."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if self.share_device:
            return torch.device("cuda", 0)
        return torch.device("cuda", rank_and_size()[0] if rank is None else rank)

    def describe(self) -> str:
        devs = sorted({str(self.device(r)) for r in range(self.size)})
        return f"{self.backend}, world size {self.size}, devices {', '.join(devs)}"


def make_mesh(n_devices: Optional[int], device="cuda",
              share_device: bool = False) -> Optional[Mesh]:
    """A mesh of n_devices ranks, or None (one device, no process group)
    for None or 1. On CUDA, 0 means every local GPU, and more ranks than
    GPUs raise ValueError unless share_device puts them all on cuda:0. On
    the CPU any count runs (gloo processes), and 0 raises: there is no
    device count to take."""
    dev = torch.device(device)
    if n_devices is None or int(n_devices) == 1:
        return None
    n = int(n_devices)
    if dev.type == "cpu":
        if n <= 0:
            raise ValueError(
                "make_mesh: --mesh_shape 0 means every local GPU; on the CPU give the "
                "number of ranks (processes) explicitly")
        return Mesh(n, "cpu") if n > 1 else None
    if dev.type != "cuda":
        raise ValueError(f"make_mesh: unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: a CUDA mesh needs a GPU and none is available; "
                           "pass --device cpu for a mesh of CPU processes")
    avail = torch.cuda.device_count()
    if n <= 0:
        n = avail
    if n > avail and not share_device:
        raise ValueError(
            f"make_mesh: requested {n} devices but only {avail} are available on "
            f"platform 'cuda'. One rank runs on each GPU; for a mesh of CPU processes "
            f"pass --device cpu with --mesh_shape {n}.")
    return Mesh(n, "cuda", share_device) if n > 1 else None


def mesh_from_config(cfg) -> Optional[Mesh]:
    """The data mesh the CLIs hand to the trainers: cfg.mesh_shape ranks
    (every local GPU for 0) on cfg.device; None (one device) when
    mesh_shape is unset or resolves to one."""
    return make_mesh(getattr(cfg, "mesh_shape", None), getattr(cfg, "device", "cuda"))


# ---------------------------------------------------------------------------
# spawning the ranks
# ---------------------------------------------------------------------------

class RankFailed(RuntimeError):
    """A rank of `launch` raised or died; the message holds its traceback."""


def _rank_entry(rank: int, fn: Callable, mesh: Mesh, tmp: str, args: tuple) -> None:
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    if mesh.device_type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(mesh.device(rank))
    store = dist.FileStore(os.path.join(tmp, "store"), mesh.size)
    dist.init_process_group(mesh.backend, store=store, rank=rank, world_size=mesh.size,
                            timeout=datetime.timedelta(minutes=30))
    try:
        if rank == 0:
            print(f"[mesh] {mesh.describe()}", flush=True)
        out = fn(*args)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "result.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, mesh: Mesh, *args):
    """Run fn(*args) on every rank of `mesh` (spawned processes, each with
    the process group initialised through a FileStore in a temporary
    directory) and return rank 0's result. fn must be importable by name
    (a module-level function) and its result loadable with torch.load.
    Ranks other than 0 print nothing to stdout. If a rank fails, the others
    are stopped and RankFailed carries that rank's traceback."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    with tempfile.TemporaryDirectory(prefix="dfnet_mesh_") as tmp:
        try:
            mp.start_processes(_rank_entry, args=(fn, mesh, tmp, args), nprocs=mesh.size,
                               join=True, start_method="spawn")
        except ProcessException as e:
            raise RankFailed(f"rank {e.error_index} of {mesh.size} failed:\n{e}") from None
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=False)


# ---------------------------------------------------------------------------
# helpers on tensors (the identity without a process group)
# ---------------------------------------------------------------------------

# This process's collectives: how many, the bytes it handed them (each
# input once), and, with TIME_COLLECTIVES, the seconds they took between
# two device synchronisations (off by default: the syncs cost time).
COLLECTIVES = {"calls": 0, "bytes": 0, "seconds": 0.0}
TIME_COLLECTIVES = False


def _collective(nbytes: int, fn):
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += int(nbytes)
    if not TIME_COLLECTIVES:
        return fn()
    sync = torch.cuda.synchronize if torch.cuda.is_initialized() else (lambda: None)
    sync()
    t = time.perf_counter()
    out = fn()
    sync()
    COLLECTIVES["seconds"] += time.perf_counter() - t
    return out


def rank_and_size() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main() -> bool:
    """Whether this process is rank 0 (or runs alone): the one that writes
    checkpoints, metrics and images."""
    return rank_and_size()[0] == 0


def barrier() -> None:
    if rank_and_size()[1] > 1:
        dist.barrier()


def row_counts(n_rows: int, size: Optional[int] = None) -> List[int]:
    """Rows of each rank when n_rows split as evenly as they can: the
    first n_rows % size ranks take one more."""
    size = rank_and_size()[1] if size is None else size
    base, extra = divmod(n_rows, size)
    return [base + (r < extra) for r in range(size)]


def shard_rows(n_rows: int) -> Tuple[int, int]:
    """This rank's row range [lo, hi) of n_rows (row_counts' split)."""
    rank, size = rank_and_size()
    counts = row_counts(n_rows, size)
    lo = sum(counts[:rank])
    return lo, lo + counts[rank]


def _pad_rows(x: torch.Tensor, m: int) -> torch.Tensor:
    if x.shape[0] == m:
        return x
    return torch.cat([x, x.new_zeros((m - x.shape[0],) + x.shape[1:])], 0)


def _padded_gather(x: torch.Tensor, counts: Sequence[int]) -> torch.Tensor:
    """Every rank's rows of x, in rank order (counts[r] rows from rank r)."""
    x = _pad_rows(x, max(counts)).contiguous()
    parts = [torch.empty_like(x) for _ in counts]
    _collective(x.nbytes, lambda: dist.all_gather(parts, x))
    return torch.cat([p[:c] for p, c in zip(parts, counts)], 0)


class _GatherRows(torch.autograd.Function):
    """all-gather of each rank's rows; the backward hands each rank the
    sum over ranks of the cotangents of its own rows (a reduce-scatter of
    the cotangent, each rank's segment padded to the largest, summed in
    float32 whatever the rows' dtype)."""

    @staticmethod
    def forward(ctx, x, counts):
        ctx.counts = counts
        return _padded_gather(x, counts)

    @staticmethod
    def backward(ctx, g):
        counts, m = ctx.counts, max(ctx.counts)
        padded = torch.cat([_pad_rows(s, m) for s in g.split(list(counts))], 0)
        padded = padded.float().contiguous()
        out = padded.new_empty((m,) + g.shape[1:])
        _collective(padded.nbytes, lambda: dist.reduce_scatter_tensor(out, padded))
        return out[:counts[dist.get_rank()]].to(g.dtype), None


def gather_rows(x: torch.Tensor, counts: Sequence[int]) -> torch.Tensor:
    """Concatenate every rank's rows of x along dim 0, in rank order. Rank
    r holds counts[r] rows (uneven counts are allowed; row_counts gives
    shard_rows' split). Differentiable: a rank's rows get the summed
    cotangents of all ranks, so when every rank computes the same loss
    from the result, the grads averaged over ranks are the one-device
    grads."""
    if rank_and_size()[1] == 1:
        return x
    counts = tuple(int(c) for c in counts)
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, counts)
    return _padded_gather(x, counts)


def all_reduce_grads_(leaves: Sequence[torch.Tensor], weight: float = 1.0,
                      extra: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Set each leaf's .grad to the sum over ranks of weight * its grad,
    in one flattened float32 bucket (one all-reduce a step). A leaf with no
    grad enters as zeros (Adam's rule here: its moments decay), so the
    buckets line up on every rank. `extra` (any float tensor, e.g. the
    step's loss) rides the same bucket, weighted alike; its reduced value
    is returned."""
    if rank_and_size()[1] == 1:
        return extra
    grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves]
    parts = [g.reshape(-1).float() for g in grads]
    if extra is not None:
        parts.append(extra.detach().reshape(-1).float().to(parts[0].device))
    flat = torch.cat(parts)
    if weight != 1.0:
        flat.mul_(weight)
    _collective(flat.nbytes, lambda: dist.all_reduce(flat))
    o = 0
    for t in leaves:
        n = t.numel()
        t.grad = flat[o:o + n].view_as(t).to(t.dtype)
        o += n
    if extra is None:
        return None
    return flat[o:].reshape(extra.shape).to(extra.dtype)


def agree(*values: float) -> Tuple[float, ...]:
    """The mean over ranks of host scalars, in float64, so that every rank
    takes the same decision on them (early stopping, the LR schedule); the
    values themselves where there is no process group."""
    if rank_and_size()[1] == 1:
        return tuple(float(v) for v in values)
    t = torch.tensor(np.asarray(values, np.float64))
    if dist.get_backend() == "nccl":
        t = t.cuda()
    _collective(t.nbytes, lambda: dist.all_reduce(t))
    return tuple(float(v) for v in (t / dist.get_world_size()).cpu())
