"""Profiling (port of neo360_tpu/train/profiling.py): `trace`,
`summarize` and `constant_counts`, and the span recorder's public names (`item`, `span`, `items`, `enable`, `clear`,
`MAX_ITEMS`, and `noting`, `credit`, `graphs` for the tile renderer's
CUDA graph), which live in `core/spans.py` and are re-exported here: the
benchmark reads the recorder through this module.

`trace` records a `torch.profiler` run (host activity, and the card's
kernels when CUDA is available) and writes it into a directory as a
Chrome trace (`*.pt.trace.json`: chrome://tracing, Perfetto or
TensorBoard's profiler plugin), where the JAX package writes an xprof
trace. `summarize` prints a traced run's per-op table (the counterpart of
scripts/profile_step.py:summarize_xspace).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from neo360_tpu_torch.core.constants import cached as _constants
# the recorder's public names, re-exported (module docstring)
from neo360_tpu_torch.core.spans import MAX_ITEMS, clear, credit, enable, \
    graphs, item, items, noting, span  # noqa: F401


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


def constant_counts() -> Dict[str, int]:
    """The process's constants (`core/constants.py:cached`): {"builds":
    entries built, "hits": lookups served by an entry already built}."""
    return {"builds": _constants.builds, "hits": _constants.hits}


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
    (C entry name -> launches, from `ops/kernels.py:launches`). A run
    without CUDA records no device time: the table then lists host ops by
    self CPU time, and the device time and busy share are None. Returns {"device_ms", "busy_share",
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
