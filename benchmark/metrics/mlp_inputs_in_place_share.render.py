"""The share of a view's conditioned-MLP inputs whose encoding columns the
card's `pos_enc_into` kernel wrote in place: 100 x the kernel's launches
in the profiled view (the device trace) over the view's inputs, two (fg
and bg) a `model.gather` span (one a conditioned level of a tile; a
replayed tile's spans are credited) of the program's recorder (spans.py).
An input concatenated again launches no such kernel and lowers the share.
None in training, without a trace or the recorder, and where the trace
holds no launch of the kernel (a program that concatenates every
input)."""

import sys

from benchmark.readers import is_train
from benchmark.spans import KIND, RECORDER

KERNEL = "pos_enc_into_kernel"


def read(ctx):
    tr, profiling = ctx["trace"], sys.modules.get(RECORDER)
    if is_train(ctx) or tr is None or not hasattr(profiling, "items"):
        return None
    launches = sum(k["launches"] for name, k in tr["kernels"].items()
                   if KERNEL in name)
    views = [it for it in profiling.items() if it["name"] == KIND[ctx["kind"]]]
    gathers = views[-1]["spans"].get("model.gather", {}).get("count", 0) \
        if views else 0
    if not launches or not gathers:
        return None
    return 100.0 * launches / (2 * gathers)
