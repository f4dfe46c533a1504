"""The program's own spans (`neo360_tpu_torch/train/profiling.py`, the
recorder every architecture of the port shares), read for the per-layer
metrics of source `program_span`. The recorder is the module the program
has loaded (`sys.modules`); nothing of the program is imported here.

The window's items are the last `ctx["items"]` item spans of the cell's
kind (a training step, a stage or a view) before the profiled one, which
is the last item when `ctx["trace"]` is set. A phase's figure is its
spans' device-timeline ms in an item, summed over the item, divided by
the item's training steps (`ctx["steps_per_item"]`): the median over the
window's items. Where only some spans of a name took device markers (one
tile in sixteen of a view), the recorder scales their sum to all of them;
`timed` counts the marked ones. The first read of a run logs the window's
span table to standard error as `[spans]` lines. A program without the
recorder (or not loaded), or without device markers (the CPU), gives
None.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List, Optional

RECORDER = "neo360_tpu_torch.train.profiling"
KIND = {"step": "train.step", "stage": "train.stage", "view": "render.view"}
FIELDS = ("count", "host_ms", "self_host_ms", "device_ms", "self_device_ms",
          "timed")


def window_items(records: List[Dict], ctx: Dict) -> List[Dict]:
    """The window's items among the recorder's `records` (oldest first)."""
    mine = [r for r in records if r["name"] == KIND.get(ctx["kind"])]
    if ctx.get("trace") is not None:
        mine = mine[:-1]
    return mine[-ctx["items"]:] if ctx["items"] else []


def _window(ctx: Dict) -> List[Dict]:
    """The window's items, read once a run (kept in ctx) and logged."""
    if "span_window" not in ctx:
        ctx["span_window"] = []
        profiling = sys.modules.get(RECORDER)
        if hasattr(profiling, "items"):
            ctx["span_window"] = window_items(profiling.items(), ctx)
            _log(ctx)
    return ctx["span_window"]


def _median(values) -> Optional[float]:
    values = list(values)
    if not values or any(v is None for v in values):
        return None
    return statistics.median(values)


def table(ctx: Dict) -> Dict[str, Dict]:
    """Span name -> each of FIELDS in an item, the median over the
    window's items (an item without the name counts 0)."""
    window = _window(ctx)
    names = sorted({n for it in window for n in it["spans"]})
    zero = dict.fromkeys(FIELDS, 0)
    return {n: {f: _median(it["spans"].get(n, zero)[f] for it in window)
                for f in FIELDS} for n in names}


def _log(ctx: Dict) -> None:
    window = ctx["span_window"]
    if not window:
        return
    item_ms = 1e3 * ctx["window_s"] / ctx["items"]
    lines = [f"[spans] {len(window)} {KIND[ctx['kind']]} items, "
             f"{item_ms:.4f} ms an item over the window; medians an item: "
             f"name " + " ".join(FIELDS)]
    for name, row in table(ctx).items():
        lines.append(f"[spans] {name} " + " ".join(
            "None" if row[f] is None else f"{row[f]:.4f}" for f in FIELDS))
    print("\n".join(lines), file=sys.stderr, flush=True)


def phase_ms(ctx: Dict, name: str) -> Optional[float]:
    """The phase's device-timeline ms a training step (a view in a render
    cell), or None."""
    window = _window(ctx)
    if not any(name in it["spans"] for it in window):
        return None
    ms = _median(it["spans"].get(name, {"device_ms": 0.0})["device_ms"]
                 for it in window)
    return None if ms is None else ms / ctx["steps_per_item"]
