"""The device's peak allocated memory over the window (reset before it)."""

from benchmark.readers import peak_gib, is_train


def read(ctx):
    return peak_gib(ctx) if is_train(ctx) else None
