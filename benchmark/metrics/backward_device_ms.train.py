"""The backward's device-timeline ms a training step, the encoder's
recompute included: the program's `train.backward` spans, the median
over the window's items (spans.py)."""

from benchmark.readers import is_train
from benchmark.spans import phase_ms


def read(ctx):
    return phase_ms(ctx, "train.backward") if is_train(ctx) else None
