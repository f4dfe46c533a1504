"""Profiling and throughput (port of neo360_tpu/train/profiling.py).

`trace` records a `torch.profiler` run (host activity, and the card's
kernels when CUDA is available) and writes it into a directory as a
Chrome trace (`*.pt.trace.json`: chrome://tracing, Perfetto or
TensorBoard's profiler plugin), where the JAX package writes an xprof
trace. `annotate` names a span in it (`record_function`).
`ThroughputMeter` counts rays per second over a sliding window.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write its trace into `log_dir`. Usage:
    `with trace("profile"): run_steps()`. Yields the profiler; the card's
    queued work is waited for before the trace closes."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()


def annotate(name: str):
    """A named span in the profiler's trace (a context manager)."""
    return torch.profiler.record_function(name)


class ThroughputMeter:
    """Sliding-window rays/sec (and steps/sec) tracker, on the host clock.
    A caller timing work on the card synchronizes it (e.g.
    `torch.cuda.synchronize()`) before each `update`, or the meter counts
    the launches, not the work."""

    def __init__(self, window: int = 50):
        self.window = window
        self._events = []  # (time, rays)

    def update(self, rays: int):
        self._events.append((time.time(), rays))
        if len(self._events) > self.window:
            self._events.pop(0)

    @property
    def rays_per_sec(self) -> Optional[float]:
        if len(self._events) < 2:
            return None
        dt = self._events[-1][0] - self._events[0][0]
        rays = sum(r for _, r in self._events[1:])
        return rays / dt if dt > 0 else None

    @property
    def steps_per_sec(self) -> Optional[float]:
        if len(self._events) < 2:
            return None
        dt = self._events[-1][0] - self._events[0][0]
        return (len(self._events) - 1) / dt if dt > 0 else None
