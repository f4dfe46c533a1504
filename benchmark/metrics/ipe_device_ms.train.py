"""The integrated positional encoding's device-timeline ms a training
step, over its levels (the contraction with its Jacobian, the lift onto
the basis and the IPE): the program's `model.ipe` spans, the median over
the window's items (spans.py)."""

from benchmark.readers import is_train
from benchmark.spans import phase_ms


def read(ctx):
    return phase_ms(ctx, "model.ipe") if is_train(ctx) else None
