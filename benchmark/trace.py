"""One item under `torch.profiler` (host and device), read from its Chrome
trace: the device's busy time (the union of kernel, copy and memset
intervals), each kernel's device time and launches by name, the longest
idle gaps of the device by what the host was doing then (the innermost
top-level host op of any thread covering the gap's midpoint), and the
traced window's length. The trace file is written under TMPDIR and
deleted once read."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _merge(intervals: List[Tuple[float, float]]):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _top_level(ops):
    """Per thread, the ops not inside another op of that thread: sorted
    (start, end, name) lists."""
    by_tid = defaultdict(list)
    for e in ops:
        by_tid[e.get("tid")].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    tops = {}
    for tid, evs in by_tid.items():
        evs.sort(key=lambda x: (x[0], -x[1]))
        keep, end = [], -1.0
        for a, b, name in evs:
            if a >= end:
                keep.append((a, b, name))
                end = b
        tops[tid] = keep
    return tops


def _host_at(tops, t: float) -> str:
    best = None
    for evs in tops.values():
        i = bisect.bisect_right(evs, (t, float("inf"), "")) - 1
        if i >= 0 and evs[i][0] <= t <= evs[i][1]:
            if best is None or evs[i][1] - evs[i][0] < best[1] - best[0]:
                best = evs[i]
    return best[2] if best else "python, no op"


def read(events: List[Dict], top: int = 10) -> Dict:
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    ops = [e for e in xs if e.get("cat") == "cpu_op"]
    kernels = defaultdict(lambda: [0.0, 0])
    for e in dev:
        if e["cat"] == "kernel":
            k = kernels[e["name"]]
            k[0] += e["dur"] * 1e-6
            k[1] += 1
    busy = _merge([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    start = min((e["ts"] for e in xs), default=0.0)
    end = max((e["ts"] + e["dur"] for e in xs), default=0.0)
    gaps, at = defaultdict(float), start
    tops = _top_level(ops)
    for a, b in busy + [[end, end]]:
        if a > at:
            gaps[_host_at(tops, 0.5 * (at + a))] += (a - at) * 1e-6
        at = max(at, b)
    by_time = sorted(((t, n) for n, (t, _) in kernels.items()), reverse=True)
    copies = defaultdict(float)
    for e in dev:
        if e["cat"] != "kernel":
            copies[e["name"]] += e["dur"] * 1e-6
    device_ops = sorted([(t, n[:160]) for t, n in by_time]
                        + [(t, n) for n, t in copies.items()],
                        reverse=True)[:top]
    return {"kernels": {n: {"seconds": t, "launches": c}
                        for n, (t, c) in kernels.items()},
            "launches": sum(c for _, c in kernels.values()),
            "busy_s": busy_s,
            "device_ops": [[n, t] for t, n in device_ops],
            "idle_gaps": [[n, t] for n, t in sorted(
                gaps.items(), key=lambda x: -x[1])[:top]]}


def profile(fn: Callable[[], object], sync: Callable[[], None]) -> Dict:
    """Run fn once under the profiler; returns `read`'s dict with
    `window_s`, the profiled run's host-clock length."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = read(events)
    out["window_s"] = window_s
    return out
