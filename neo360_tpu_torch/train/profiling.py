"""Profiling (port of neo360_tpu/train/profiling.py) and the port's span
recorder.

`item(name)` and `span(name)` time the phases of the program: context
managers that record their name and their start and end on the host clock
(`time.perf_counter_ns`). An item is a unit of work the benchmark counts
(a training step, a rendered view), opened by `item`; every span inside
it belongs to it, nested as the calls nest, and each thread has its own
open item. A span outside any item records nothing, so the model's spans
cost one check on paths that open no item (the stage trainer). The
recorder is always on; `enable(False)` opens no item, so that its cost
can be measured.

On CUDA a span also takes a device marker at its start and its end: a
pooled timing `torch.cuda.Event` recorded on the item's stream. A span
that begins where another ended (no span boundary between the end of the
one and the start of the other) shares that span's end marker, so the
work launched between them counts in the later one. The gap between a
span's markers is its device-timeline time: the device time its work
occupied, idle time inside it included. `span(name, device=False)` takes
no marker, nor does any span inside it: the tile renderer marks one tile
in `loop.MARKED_TILES`, because a marker costs the host about a launch.
An item's markers are read (`Event.elapsed_time`) once its last one is
complete, checked when an item opens or closes, and at the latest when
the item after next closes; the events then go back to the pool. On the
CPU, or where a marker fails, device times are None.

While `torch.profiler` records, each span is also a `record_function` in
the profiler's trace, on the kernels' clock; otherwise `record_function`
is not called.

Each closed item is folded into a per-name table (`items()`): the spans'
count, host ms, self host ms (less their child spans'), device ms and
self device ms, and how many of the spans were timed on the device. The
last `MAX_ITEMS` items are kept, each with the constants built and
served while it was open (`core/constants.py`; `constant_counts` gives
the process's totals).

`trace` records a `torch.profiler` run (host activity, and the card's
kernels when CUDA is available) and writes it into a directory as a
Chrome trace (`*.pt.trace.json`: chrome://tracing, Perfetto or
TensorBoard's profiler plugin), where the JAX package writes an xprof
trace. `summarize` prints a traced run's per-op table (the counterpart of
scripts/profile_step.py:summarize_xspace). `kernel_counters` names the
launch counter of each of the port's kernels.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import warnings
from collections import deque
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from neo360_tpu_torch.core.constants import cached as _constants

MAX_ITEMS = 256

_on = True
_now = time.perf_counter_ns
_lock = threading.Lock()
_ids = itertools.count()
_pool: List = []            # free timing events
_pending: deque = deque()   # closed items whose markers are not read yet
_done: deque = deque(maxlen=MAX_ITEMS)


def enable(on: bool) -> None:
    """Record items and their spans (the default) or not."""
    global _on
    _on = bool(on)


class _Item:
    __slots__ = ("id", "name", "log", "depth", "events", "stream",
                 "marking", "off", "last", "table", "constants")

    def __init__(self, name: str, stream):
        self.id = next(_ids)
        self.name = name
        # per span start: (name, ns, marker); per span end: (None, ns,
        # marker); a marker is an index into `events`, -1 for none
        self.log: Optional[List[tuple]] = []
        self.depth = 0
        self.stream = stream
        self.events: Optional[List] = None if stream is None else []
        self.marking = stream is not None
        self.off = -1       # the depth of the span that stopped the markers
        self.last = -1      # the end marker a span starting now would share
        # span name -> [count, host ns, self host ns, device ms, timed,
        # self device ms, self timed]
        self.table: Dict[str, list] = {}
        # the constants' (builds, hits) when the item opened; when it
        # closes, those while it was open
        self.constants = (_constants.builds, _constants.hits)

    def mark(self) -> int:
        """Record a marker on the item's stream; its index. A marker that
        fails leaves the item without device times."""
        try:
            try:
                ev = _pool.pop()
            except IndexError:
                ev = torch.cuda.Event(enable_timing=True)
            ev.record(self.stream)
        except RuntimeError as e:
            _lost(self, e)
            self.marking = False
            return -1
        self.events.append(ev)
        return len(self.events) - 1


class _Thread(threading.local):
    """A thread's open item, and its spans' `record_function`s while the
    profiler records."""

    def __init__(self):
        self.item: Optional[_Item] = None
        self.rfs: List[tuple] = []


_thread = _Thread()


class _Span:
    __slots__ = ("name", "device")

    def __init__(self, name: str, device: bool = True):
        self.name = name
        self.device = device

    def __enter__(self):
        th = _thread
        if _autograd_profiler._is_profiler_enabled:
            rf = torch.profiler.record_function(self.name)
            rf.__enter__()
            th.rfs.append((self, rf))
        item = th.item
        if item is not None:
            m = -1
            if item.marking:
                if self.device:
                    m = item.last
                    if m < 0:
                        m = item.mark()
                else:
                    item.marking = False
                    item.off = item.depth
            item.last = -1
            item.depth += 1
            item.log.append((self.name, _now(), m))
        return self

    def __exit__(self, *exc):
        th = _thread
        item = th.item
        if item is not None:
            t = _now()
            m = item.mark() if item.marking else -1
            item.log.append((None, t, m))
            item.last = m
            depth = item.depth = item.depth - 1
            if depth == item.off:
                item.off = -1
                item.marking = item.events is not None
            if depth == 0:
                th.item = None
                b, h = item.constants
                item.constants = (_constants.builds - b, _constants.hits - h)
                _close(item)
        rfs = th.rfs
        if rfs and rfs[-1][0] is self:
            rfs.pop()[1].__exit__(*exc)
        return False


class _ItemSpan(_Span):
    __slots__ = ()

    def __enter__(self):
        th = _thread
        if th.item is None and _on:
            if _pending:
                with _lock:
                    _read_ready()
            th.item = _Item(self.name, torch.cuda.current_stream()
                            if torch.cuda.is_initialized() else None)
        return _Span.__enter__(self)


_spans: Dict[bool, Dict[str, _Span]] = {True: {}, False: {}}


def span(name: str, device: bool = True) -> _Span:
    """A named phase inside the open item (a context manager, one per name
    and `device`, holding no state); with `device=False` it and the spans
    inside it take no device marker (module docstring)."""
    try:
        return _spans[device][name]
    except KeyError:
        made = _spans[device][name] = _Span(name, device)
        return made


def item(name: str) -> _Span:
    """A named item: opens one unless the thread has one open, in which
    case it is a span of that item (module docstring)."""
    return _ItemSpan(name)


def _close(item: _Item) -> None:
    """Keep the item: folded now without markers; else once its markers
    are complete, by the time the item after next closes."""
    with _lock:
        if item.events is None:
            _fold(item, None)
            return
        _pending.append(item)
        while len(_pending) > 2:
            _read(_pending.popleft())
        _read_ready()


def _read_ready() -> None:
    """Read the items whose markers are complete, oldest first."""
    while _pending:
        try:
            if not _pending[0].events[-1].query():
                return
        except RuntimeError:
            pass                # _read reports it
        _read(_pending.popleft())


def _read(item: _Item) -> None:
    """Each marker's ms from the item's first, then fold the item; its
    events go back to the pool."""
    events = item.events
    try:
        events[-1].synchronize()
        first = events[0]
        at = [first.elapsed_time(ev) for ev in events]
    except RuntimeError as e:
        _lost(item, e)
        at = None
    else:
        _pool.extend(events)
    _fold(item, at)


def _lost(item: _Item, error: Exception) -> None:
    """A marker failed: the item keeps its host times only."""
    item.events = None
    warnings.warn(f"span markers of item {item.name!r} failed ({error}); "
                  "its device times read None", RuntimeWarning)


def _fold(item: _Item, at: Optional[List[float]]) -> None:
    """Sum the item's spans by name into its table and keep it. `at`: each
    marker's ms from the first, or None without markers. A span's self
    device time is defined where it and all its child spans were timed."""
    table = item.table
    stack: List[list] = []
    for name, t, m in item.log:
        if name is not None:
            # name, start ns, start marker, children's ns, children's ms,
            # every child timed
            stack.append([name, t, m, 0, 0.0, True])
            continue
        name, t0, m0, child_ns, child_ms, whole = stack.pop()
        ns = t - t0
        row = table.get(name)
        if row is None:
            row = table[name] = [0, 0, 0, 0.0, 0, 0.0, 0]
        row[0] += 1
        row[1] += ns
        row[2] += ns - child_ns
        timed = at is not None and m0 >= 0 and m >= 0
        if timed:
            ms = at[m] - at[m0]
            row[3] += ms
            row[4] += 1
            if whole:
                row[5] += ms - child_ms
                row[6] += 1
        if stack:
            parent = stack[-1]
            parent[3] += ns
            if timed:
                parent[4] += ms
            else:
                parent[5] = False
    item.log = item.events = item.stream = None
    _done.append(item)


def _per_item(total: float, timed: int, count: int) -> Optional[float]:
    """A sum over the timed spans of a name, scaled to all of them."""
    return total * count / timed if timed else None


def items() -> List[Dict]:
    """The kept items, oldest first: {"id", "name" (the item's), "spans":
    {span name: {"count", "host_ms", "self_host_ms", "device_ms",
    "self_device_ms", "timed"}}, "constants": {"builds", "hits"}}, each
    figure summed over the item's spans of that name. `timed` of them took
    device markers; the device figures are their sums scaled by count /
    timed (the same where every span was timed), None where none was.
    "constants": the constants built and served while the item was open
    (every thread's)."""
    with _lock:
        while _pending:
            _read(_pending.popleft())
        return [{"id": it.id, "name": it.name, "spans": {
            name: {"count": n, "host_ms": ns * 1e-6,
                   "self_host_ms": self_ns * 1e-6,
                   "device_ms": _per_item(ms, timed, n),
                   "self_device_ms": _per_item(self_ms, self_timed, n),
                   "timed": timed}
            for name, (n, ns, self_ns, ms, timed, self_ms, self_timed)
            in it.table.items()}, "constants": dict(
                zip(("builds", "hits"), it.constants))} for it in _done]


def clear() -> None:
    """Forget the kept items (open ones go on recording)."""
    with _lock:
        while _pending:
            _read(_pending.popleft())
        _done.clear()


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


def kernel_counters() -> Dict[str, Callable]:
    """Counter name -> the wrapper that counts its kernel's launches (its
    `launches` attribute): one per kernel of the port, and kernel A' under
    each of its two contracts (dense and accumulate). A wrapper counts only
    where it launches its kernel, on CUDA tensors; its plain version on the
    CPU counts nothing."""
    from neo360_tpu_torch.core.render import composite_mip, \
        composite_mip_backward, composite_nerfpp, composite_nerfpp_backward, \
        composite_vanilla, composite_vanilla_backward
    from neo360_tpu_torch.ops.interpolate import grid_sample_2d, \
        grid_sample_2d_backward, local_sample, table_sample, \
        table_sample_accumulate, table_sample_backward, triplane_sample
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
            "composite_mip_bwd": composite_mip_backward,
            "grid_sample_fwd": grid_sample_2d,
            "grid_sample_bwd": grid_sample_2d_backward}


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
