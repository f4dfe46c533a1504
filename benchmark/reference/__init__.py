"""The benchmark's plain reference of NeO-360: `model` (the network, its
sampling, compositing and losses) and `train` (Adam, the schedule and the
per-step and stage trainers). Plain PyTorch and NumPy; nothing of the
measured program, of JAX or of the JAX package is imported."""
