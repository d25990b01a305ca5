"""Data-parallel execution across ranks (torch.distributed)."""
