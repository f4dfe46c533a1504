"""The least time of the operation families whose kernels the profiled item
ran (rooflines/), over those kernels' device time."""

from benchmark.readers import roofline_share, is_train


def read(ctx):
    return roofline_share(ctx) if not is_train(ctx) else None
