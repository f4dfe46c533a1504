"""Kernels launched on the device in the profiled stage or step, per training step (a stage is K steps): the
host's launch work that the trainers set going."""

from benchmark.readers import is_train, launches_per_step


def read(ctx):
    return launches_per_step(ctx) if is_train(ctx) else None
