"""The MLPs' device-timeline ms a training step, over its levels (with
their inputs' encodings): the program's `model.mlp` spans, the median
over the window's items (spans.py)."""

from benchmark.readers import is_train
from benchmark.spans import phase_ms


def read(ctx):
    return phase_ms(ctx, "model.mlp") if is_train(ctx) else None
