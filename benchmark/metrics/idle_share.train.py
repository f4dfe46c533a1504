"""1 - the device's busy time in the profiled item, over the unprofiled
seconds of one item of the window."""

from benchmark.readers import idle_share, is_train


def read(ctx):
    return idle_share(ctx) if is_train(ctx) else None
