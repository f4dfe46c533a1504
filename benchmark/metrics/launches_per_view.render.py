"""Kernels launched on the device in the profiled view: the
host's launch work that the tile renderer sets going."""

from benchmark.readers import is_train, launches_per_step


def read(ctx):
    return launches_per_step(ctx) if not is_train(ctx) else None
