"""The benchmark's plain references, one or more modules per architecture,
which its adapter (architectures/) imports. NeO-360's: `model` (the
network, its sampling, compositing and losses) and `train` (Adam, the
schedule and the per-step and stage trainers). Plain PyTorch and NumPy;
nothing of the measured program, of JAX or of the JAX package is
imported."""
