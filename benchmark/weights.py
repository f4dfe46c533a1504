"""Seeded weights for both sides of a comparison: one float32 normal draw
on the device, from a `torch.Generator` seeded by the run's seed, sliced
and scaled into every tensor of the program's `state_dict()` (names and
shapes are the interface; values are the benchmark's own):

- a matrix or kernel (`*.weight`, two or more axes): kaiming normal,
  std sqrt(2 / fan_in), fan_in = its size over the first axis;
- a BatchNorm's scale 1 + N(0, 0.1) and shift N(0, 0.1), running mean 0
  and running variance 1 (a BatchNorm is a prefix with `running_mean`);
- any other tensor (biases, the pillar aggregator's coordinate weights
  and biases): N(0, 0.01), coordinate weights N(0, 0.5).

Every band of the positional encoding keeps its full gain, so a fault in
the highest band moves the output as much as one in the lowest.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def derive(seed: int, purpose: int) -> int:
    """A 63-bit seed for `purpose` from the run's seed (any size)."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, purpose])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make(shapes: Dict[str, Tuple[int, ...]], seed: int, device
         ) -> Dict[str, torch.Tensor]:
    """Float32 tensors for every name of `shapes`, in its order."""
    gen = torch.Generator(device).manual_seed(derive(seed, 1))
    total = sum(int(np.prod(s)) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    bn = {k[:-len("running_mean")] for k in shapes
          if k.endswith("running_mean")}
    out, at = {}, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        z = flat[at:at + n].reshape(shape)
        at += n
        prefix, _, leaf = name.rpartition(".")
        prefix += "."
        if prefix in bn:
            out[name] = {"weight": 1.0 + 0.1 * z, "bias": 0.1 * z,
                         "running_mean": torch.zeros_like(z),
                         "running_var": torch.ones_like(z)}[leaf]
        elif leaf == "weight" and len(shape) >= 2:
            out[name] = z * float(np.sqrt(2.0 * shape[0] / n))
        elif leaf == "coord_w":
            out[name] = 0.5 * z
        else:
            out[name] = 0.01 * z
    return out
