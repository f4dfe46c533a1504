"""The arithmetic of the per-layer metrics, shared by their readers
(`metrics/<name>.py`). Each reader gets the run's context:

- `kind`: "stage", "step" or "view"; `items`, `window_s`: the unprofiled
  window's completed items and seconds; `steps_per_item`;
- `work`, `flops_item`, `peak_flops`: the item's work and its model FLOPs
  (the architecture's adapter: `work`, `item_flops`) and the
  configuration's peak;
- `trace`: one more item profiled after the window (trace.py), or None;
- `peak_bytes`: the device's peak allocation over the window;
- `families`: the adapter's roofline families (registry.py).
A reader that finds nothing to read returns None.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

# NVIDIA H100 SXM data sheet: HBM3 bandwidth of one card at 700 W
HBM_BYTES_PER_S = 3.35e12


def is_train(ctx: Dict) -> bool:
    return ctx["kind"] in ("stage", "step")


def launches_per_step(ctx: Dict) -> Optional[float]:
    tr = ctx["trace"]
    if tr is None or tr["launches"] == 0:
        return None
    return tr["launches"] / ctx["steps_per_item"]


def mfu(ctx: Dict) -> Optional[float]:
    if not ctx["items"] or ctx["window_s"] <= 0:
        return None
    rate = ctx["flops_item"] * ctx["items"] / ctx["window_s"]
    return 100.0 * rate / ctx["peak_flops"]


def item_s(ctx: Dict) -> float:
    return ctx["window_s"] / ctx["items"]


def idle_share(ctx: Dict) -> Optional[float]:
    tr = ctx["trace"]
    if tr is None or tr["busy_s"] <= 0 or not ctx["items"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / item_s(ctx))


def roofline_share(ctx: Dict) -> Optional[float]:
    """Least time of the families whose kernels the trace holds, over
    those kernels' device time: the work's bytes at the card's bandwidth,
    so a kernel renamed or fused away drops out of both sides."""
    tr = ctx["trace"]
    if tr is None:
        return None
    bound = spent = 0.0
    for fam in ctx["families"].values():
        pats = [re.compile(p) for p in fam.KERNELS]
        secs = sum(k["seconds"] for name, k in tr["kernels"].items()
                   if any(p.search(name) for p in pats))
        least = fam.least_bytes(ctx["work"]) / HBM_BYTES_PER_S
        if secs > 0 and least > 0:
            bound += least
            spent += secs
    return 100.0 * bound / spent if spent > 0 else None


def peak_gib(ctx: Dict) -> Optional[float]:
    return ctx["peak_bytes"] / 2 ** 30 if ctx["peak_bytes"] else None
