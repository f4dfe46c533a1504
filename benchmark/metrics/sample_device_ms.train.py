"""The ray samples' device-timeline ms a training step, over its levels
(the dilation, the resampling, the s-to-t warp and the cone Gaussians):
the program's `model.sample` spans, the median over the window's items
(spans.py)."""

from benchmark.readers import is_train
from benchmark.spans import phase_ms


def read(ctx):
    return phase_ms(ctx, "model.sample") if is_train(ctx) else None
