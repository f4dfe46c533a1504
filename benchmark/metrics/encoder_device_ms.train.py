"""The encoder's device-timeline ms a training step: the program's
`model.encode` spans (NeRFTP.encode), the median over the window's
items (spans.py)."""

from benchmark.readers import is_train
from benchmark.spans import phase_ms


def read(ctx):
    return phase_ms(ctx, "model.encode") if is_train(ctx) else None
