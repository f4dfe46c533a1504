"""The update's device-timeline ms a training step (the optimizer and the
running statistics): the program's `train.update` spans, the median
over the window's items (spans.py)."""

from benchmark.readers import is_train
from benchmark.spans import phase_ms


def read(ctx):
    return phase_ms(ctx, "train.update") if is_train(ctx) else None
