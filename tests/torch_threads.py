"""Imported first by every tests/test_torch_*.py file. Under pytest-xdist
it caps torch's intra-op threads at this worker's share of the CPUs:
torch would otherwise run each worker's ops on every core, beside the
other workers and JAX's own pools. Outside xdist it does nothing."""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // _WORKERS))
