"""The ray samples' device-timeline ms a view, over its tiles and levels:
the program's `model.sample` spans, the median over the window's
items (spans.py)."""

from benchmark.readers import is_train
from benchmark.spans import phase_ms


def read(ctx):
    return phase_ms(ctx, "model.sample") if not is_train(ctx) else None
