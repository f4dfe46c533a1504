"""Model FLOPs (flops.py) of the window's items over the window's unprofiled
seconds, as a share of the configuration's peak."""

from benchmark.readers import mfu, is_train


def read(ctx):
    return mfu(ctx) if is_train(ctx) else None
