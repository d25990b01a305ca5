"""Checkpointing: the JAX package's flat-npz pytree format, plus the
weight bridge between numpy pytrees and the port's torch params.

File format (shared with dfnet_tpu/training/checkpoints.py, so either
package reads what the other writes): one `.npz` whose keys are
`tree/<path>` for every leaf of the saved tree (`#i` path parts for
list/tuple items, an `@none` suffix for None) and `__scalar__<name>` for
scalars such as `global_step`. NeRF checkpoints are
`<expdir>/<epoch:06d>.npz` holding `{"params": ..., "opt_state": ...}`,
where `opt_state` is the JAX package's optax
`inject_hyperparams(adam)` state laid out as that package flattens it
(`adam_state_tree`), so each package resumes the other's optimizer warm.
"""

from __future__ import annotations

import os
import os.path as osp
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dfnet_tpu_torch.parallel.mesh import barrier, is_main


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    elif tree is None:
        out[prefix[:-1] + "@none"] = np.zeros(0)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        if key.endswith("@none"):
            key, val = key[: -len("@none")], None
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            items = sorted(node.items(), key=lambda kv: int(kv[0][1:]))
            return tuple(fix(v) for _, v in items)
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def params_from_numpy(tree, device="cpu"):
    """Numpy pytree (nested dicts/lists of arrays) -> the same tree of
    torch tensors on `device`, names and shapes unchanged. Arrays are
    copied, so the result does not alias the input."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    if tree is None:
        return None
    return torch.tensor(np.asarray(tree), device=device)


def params_to_numpy(tree):
    """Inverse of params_from_numpy: tensors -> numpy arrays (on host)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def save_pytree(path: str, tree, **scalars):
    """Write `tree` (and the named scalars) to `path`. On a mesh every rank
    calls it, rank 0 writes, and the ranks meet at a barrier after, so a
    rank that reads the file next finds it whole."""
    if is_main():
        flat = _flatten({"tree": params_to_numpy(tree)})
        for k, v in scalars.items():
            flat[f"__scalar__{k}"] = np.asarray(v)
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
        np.savez(path, **flat)
    barrier()


def load_pytree(path: str) -> Tuple[Any, Dict[str, Any]]:
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    scalars = {}
    for k in list(flat):
        if k.startswith("__scalar__"):
            scalars[k[len("__scalar__"):]] = flat.pop(k)
    tree = _unflatten(flat)["tree"]
    return tree, scalars


def latest_checkpoint(expdir: str, pattern: str = r"^(\d+)\.npz$") -> Optional[str]:
    if not osp.isdir(expdir):
        return None
    best, best_step = None, -1
    for f in os.listdir(expdir):
        m = re.match(pattern, f)
        if m and int(m.group(1)) > best_step:
            best, best_step = f, int(m.group(1))
    return osp.join(expdir, best) if best else None


ADAM_HYPER = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0}


def adam_state_tree(count: int, lr: float, mu, nu) -> tuple:
    """The optimizer state in the JAX package's checkpoint layout: optax's
    InjectStatefulHyperparamsState(count, hyperparams, hyperparams_states,
    inner_state=(ScaleByAdamState(count, mu, nu), EmptyState())). It
    flattens to `#0` (count, int32), `#1/{b1,b2,eps,eps_root,learning_rate}`
    (float32), `#3/#0/#0` (count), `#3/#0/#1/<param path>` (mu) and
    `#3/#0/#2/<param path>` (nu); the empty `#2` and EmptyState write no
    keys. mu and nu are trees shaped like the params."""
    c = np.asarray(count, np.int32)
    hyper = {k: np.asarray(v, np.float32) for k, v in ADAM_HYPER.items()}
    hyper["learning_rate"] = np.asarray(lr, np.float32)
    return (c, hyper, {}, ((c, mu, nu), ()))


def adam_state_from_tree(opt) -> Tuple[int, Dict, Any, Any]:
    """(count, hyperparams, mu, nu) from a loaded `opt_state` subtree of
    either package. Loading drops the key-less `#2` and EmptyState, so the
    tree reads back as (count, hyperparams, ((count, mu, nu),))."""
    count, hyper, inner = opt[0], opt[1], opt[-1]
    adam = inner[0]
    if not isinstance(hyper, dict) or len(adam) != 3:
        raise ValueError("opt_state is not an inject_hyperparams(adam) state")
    return int(np.asarray(count)), hyper, adam[1], adam[2]
