"""Double-buffered host-to-GPU input pipeline (port of
dfnet_tpu/data/prefetch.py).

By default a trainer keeps its splits on the device. Under `--prefetch N`
the epoch's batches are built on the host instead, and this iterator
overlaps building them and copying them with the device's work: a
producer thread keeps up to N batches ahead of the consumer. On a CUDA
device each batch is copied into pinned memory and sent with
`.to(device, non_blocking=True)` on a side stream, which records an
event; the consumer makes its current stream wait on that event and marks
each tensor as used there (`record_stream`), so the caching allocator
keeps the memory until the consumer's work is done. On the CPU it is a
plain thread queue. An error in the producer is raised on the consumer's
side, at the batch where it happened.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from dfnet_tpu_torch.device import resolve_device


def _tree_map(fn, tree):
    """fn on every array leaf of a tuple, list or dict; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class PrefetchIterator:
    """Iterate batches produced by `make_batch(idx)` with `depth` batches
    copied to `device` ahead of the consumer.

    make_batch: index -> tuple, list or dict of numpy arrays (host) or None.
    order: iterable of indices (e.g. a shuffled epoch's batches).
    Yields the same structure of torch tensors on `device`.
    """

    def __init__(self, make_batch: Callable, order, depth: int = 2, device=None):
        self._make_batch = make_batch
        self._order = list(order)
        self._device = resolve_device(device)
        cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if cuda else None
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _to_device(self, x) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(x))
        if self._stream is None:
            return t
        return t.pin_memory().to(self._device, non_blocking=True)

    def _producer(self):
        try:
            for idx in self._order:
                host = self._make_batch(idx)
                if self._stream is None:
                    self._q.put((_tree_map(self._to_device, host), None))
                    continue
                with torch.cuda.stream(self._stream):
                    dev = _tree_map(self._to_device, host)
                    ready = torch.cuda.Event()
                    ready.record(self._stream)
                self._q.put((dev, ready))
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._q.put(None)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            _tree_map(lambda t: t.record_stream(stream), batch)
        return batch

    def __len__(self):
        return len(self._order)


def epoch_prefetch(split, batch_size: int, rng: np.random.Generator, depth: int = 2,
                   drop_last: bool = True, device=None) -> PrefetchIterator:
    """Shuffled epoch iterator over a Split, yielding (images, poses, hists)
    batches on `device`."""
    n = len(split)
    order = rng.permutation(n)
    nb = n // batch_size if drop_last else -(-n // batch_size)
    batches = [order[i * batch_size:(i + 1) * batch_size] for i in range(nb)]

    def make(idx_arr):
        return (split.images[idx_arr], split.poses[idx_arr], split.hists[idx_arr])

    return PrefetchIterator(make, batches, depth=depth, device=device)
