"""Structured training-metrics logging (port of
dfnet_tpu/utils/metrics_logger.py): one JSON object per line in
`<expdir>/<name>.jsonl`, appended as training goes."""

from __future__ import annotations

import json
import os
import os.path as osp
import time

from dfnet_tpu_torch.parallel.mesh import is_main


class MetricsLogger:
    """On a mesh (parallel/mesh.py) only rank 0 writes; every rank gets the
    record back."""

    def __init__(self, expdir: str, name: str = "metrics"):
        os.makedirs(expdir, exist_ok=True)
        self.path = osp.join(expdir, f"{name}.jsonl")
        self._t0 = time.time()

    def log(self, step: int, **metrics):
        rec = {"step": int(step), "wall_s": round(time.time() - self._t0, 2)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        if is_main():
            with open(self.path, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
        return rec
