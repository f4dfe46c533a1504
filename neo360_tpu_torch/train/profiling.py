"""Profiling and throughput (port of neo360_tpu/train/profiling.py).

`trace` records a `torch.profiler` run (host activity, and the card's
kernels when CUDA is available) and writes it into a directory as a
Chrome trace (`*.pt.trace.json`: chrome://tracing, Perfetto or
TensorBoard's profiler plugin), where the JAX package writes an xprof
trace. `annotate` names a span in it (`record_function`).
`summarize` prints a traced run's per-op table (the counterpart of
scripts/profile_step.py:summarize_xspace). `kernel_counters` names the
launch counter of each of the port's kernels. `ThroughputMeter` counts
rays per second over a sliding window.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

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


def kernel_counters() -> Dict[str, Callable]:
    """Counter name -> the wrapper that counts its kernel's launches (its
    `launches` attribute): one per kernel of the NeO-360 and baseline
    paths, and kernel A' under each of its two contracts (dense and
    accumulate). A wrapper counts only where it launches its kernel, on
    CUDA tensors; its plain version on the CPU counts nothing."""
    from neo360_tpu_torch.core.render import composite_mip, \
        composite_mip_backward, composite_nerfpp, composite_nerfpp_backward, \
        composite_vanilla, composite_vanilla_backward
    from neo360_tpu_torch.ops.interpolate import local_sample, \
        table_sample, table_sample_accumulate, table_sample_backward, \
        triplane_sample
    from neo360_tpu_torch.ops.pillar import pillar_collapse, \
        pillar_collapse_backward
    return {"table_sample_fwd": table_sample,
            "triplane_sample_fwd": triplane_sample,
            "local_sample_fwd": local_sample,
            "composite_nerfpp_fwd": composite_nerfpp,
            "pillar_collapse_fwd": pillar_collapse,
            "table_sample_bwd": table_sample_backward,
            "table_sample_bwd_acc": table_sample_accumulate,
            "composite_nerfpp_bwd": composite_nerfpp_backward,
            "pillar_collapse_bwd": pillar_collapse_backward,
            "composite_vanilla_fwd": composite_vanilla,
            "composite_vanilla_bwd": composite_vanilla_backward,
            "composite_mip_fwd": composite_mip,
            "composite_mip_bwd": composite_mip_backward}


def _self_device_us(event) -> float:
    dev = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if dev is None else dev


def summarize(prof, top: int = 40, window_s: Optional[float] = None,
              launches: Optional[Dict[str, int]] = None) -> Dict:
    """Print the per-op table of a `trace`d run, on lines that start with
    "[profile]": the `top` device kernels by self device time with their
    launch counts, the total device time and, given `window_s` (the
    unprofiled time of the same work), the busy share = device time /
    window_s; then `launches`, each port kernel's launches in the run
    (from `kernel_counters`). A run without CUDA records no device time:
    the table then lists host ops by self CPU time, and the device time
    and busy share are None. Returns {"device_ms", "busy_share",
    "kernels"} (kernels: the device kernels recorded)."""
    events = prof.key_averages()
    kernels = [(_self_device_us(e) / 1e3, e.count, e.key) for e in events
               if str(e.device_type).endswith("CUDA")
               and _self_device_us(e) > 0]
    device_ms = busy = None
    if kernels:
        device_ms = sum(r[0] for r in kernels)
        n = sum(r[1] for r in kernels)
        busy = device_ms / 1e3 / window_s if window_s else None
        share = "not measured" if busy is None else f"{busy:.1%}"
        print(f"[profile] device time {device_ms:.3f} ms in {n} kernels; "
              f"busy share {share} (device time / unprofiled window "
              f"{window_s} s)")
        for ms, count, key in sorted(kernels, reverse=True)[:top]:
            print(f"[profile] {ms:10.3f} ms {ms / device_ms:6.1%} "
                  f"x{count:<7d} {ms / count * 1e3:9.1f} us/call {key[:90]}")
    else:
        print("[profile] no device time recorded (a run on the CPU): top "
              "host ops by self CPU time, device time and busy share not "
              "measured")
        host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                       for e in events if e.self_cpu_time_total > 0),
                      reverse=True)
        for ms, count, key in host[:top]:
            print(f"[profile] host {ms:10.3f} ms x{count:<7d} {key[:90]}")
    for name, count in (launches or {}).items():
        print(f"[profile] port kernel {name}: {count} launches")
    return {"device_ms": device_ms, "busy_share": busy,
            "kernels": len(kernels)}


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
