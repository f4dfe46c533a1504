"""The MLPs' device-timeline ms a view, over its tiles and levels (with
their inputs' encodings and concatenations): the program's `model.mlp`
spans, the median over the window's items (spans.py)."""

from benchmark.readers import is_train
from benchmark.spans import phase_ms


def read(ctx):
    return phase_ms(ctx, "model.mlp") if not is_train(ctx) else None
