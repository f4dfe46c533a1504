"""The latent lookups' device-timeline ms a training step, over its
levels (the samples moved into the source cameras' frames, projected and
sampled from the pixel latent): the program's `model.gather` spans, the
median over the window's items (spans.py)."""

from benchmark.readers import is_train
from benchmark.spans import phase_ms


def read(ctx):
    return phase_ms(ctx, "model.gather") if is_train(ctx) else None
