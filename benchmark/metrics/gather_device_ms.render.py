"""The feature gathers' device-timeline ms a view, over its tiles and
levels (world2camera, the tri-plane and local gathers): the program's
`model.gather` spans, the median over the window's items (spans.py)."""

from benchmark.readers import is_train
from benchmark.spans import phase_ms


def read(ctx):
    return phase_ms(ctx, "model.gather") if not is_train(ctx) else None
