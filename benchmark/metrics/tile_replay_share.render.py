"""The share of a view's tiles the tile renderer replayed from its CUDA
graph: 100 x replayed / (replayed + eager + captured), from the per-item
"graphs" counts of the program's recorder (spans.py), the median over the
window's items. None where the items carry no such counts (a program
without the graph) or count no tile."""

import statistics
import sys

from benchmark.readers import is_train
from benchmark.spans import RECORDER, window_items


def read(ctx):
    profiling = sys.modules.get(RECORDER)
    if is_train(ctx) or not hasattr(profiling, "items"):
        return None
    shares = []
    for it in window_items(profiling.items(), ctx):
        tiles = it.get("graphs")
        total = sum(tiles.values()) if tiles else 0
        if not total:
            return None
        shares.append(100.0 * tiles["replayed"] / total)
    return statistics.median(shares) if shares else None
