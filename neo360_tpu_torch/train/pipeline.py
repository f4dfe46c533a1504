"""Host -> device input pipeline (port of neo360_tpu/train/pipeline.py:
train_iterator and prefetch_to_device).

A daemon thread runs the host sampler, places each item on the device (or
leaves it on the host) and keeps `size` items buffered, so the device never
waits on ray generation.
Placement copies numpy arrays into pinned host memory and from
there to the device with `non_blocking=True`: the copy is queued on the
device's stream, ordered before the kernels that read it. The thread
makes that device its current one, so a data-parallel rank's batches go
to its own card.

Consumers that stop early must call `.close()` (or use the prefetcher as a
context manager); a producer failure is re-raised in the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch


def to_device(item, device):
    """numpy arrays (in dicts, lists and tuples) -> tensors on `device`,
    through pinned memory when `device` is a CUDA device."""
    if isinstance(item, dict):
        return {k: to_device(v, device) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(to_device(v, device) for v in item)
    t = torch.from_numpy(np.ascontiguousarray(item))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def train_iterator(dataset, seed: int = 0) -> Iterator:
    """Infinite iterator of training samples from a NeRDS360AE-style
    dataset (anything with .sample_train(rng)), drawn from one numpy
    Generator seeded with `seed`."""
    rng = np.random.default_rng(seed)
    while True:
        yield dataset.sample_train(rng)


class _Prefetcher:
    _SENTINEL = object()

    def __init__(self, iterator: Iterator, size: int,
                 place_fn: Callable, device=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=size)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._place = place_fn
        self._device = device
        self._thread = threading.Thread(target=self._produce,
                                        args=(iterator,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, iterator):
        try:
            dev = None if self._device is None else torch.device(
                self._device)
            if dev is not None and dev.type == "cuda" and \
                    dev.index is not None:
                torch.cuda.set_device(dev)
            for item in iterator:
                if not self._put(self._place(item)):
                    return
        except BaseException as e:   # surfaced to the consumer
            self._exc = e
        finally:
            self._put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is self._SENTINEL:
            self._stop.set()
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def close(self):
        """Stop the producer thread and release its queue slot."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def prefetch_to_device(iterator: Iterator, size: int = 2, *,
                       device) -> _Prefetcher:
    """Run `iterator` in a daemon thread, place each item on `device`
    (`to_device`; no default: the caller names the card or the CPU, or
    None to leave the items on the host as the iterator yields them, as
    the JAX run_eval's identity placement does), keep `size` items
    buffered."""
    place = (lambda item: item) if device is None else (
        lambda item: to_device(item, device))
    return _Prefetcher(iterator, size, place, device)
