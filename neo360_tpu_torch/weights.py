"""Weight carry-over from the JAX package.

The Flax variable tree exports to a flat npz with '/'-joined keys
(neo360_tpu/utils/io.py:save_variables_npz), e.g.
`params/encoder/depth_fc/fc0/kernel` or
`batch_stats/encoder/floorplan_xy/bn0/mean`. The port's modules carry the
same names, so a key maps to the state_dict entry `encoder.depth_fc.fc0.weight`
after these conversions:

- Dense `kernel` (in, out) -> `weight` (out, in);
- Conv `kernel` HWIO -> `weight` OIHW;
- BatchNorm `scale`/`bias` -> `weight`/`bias`, `mean`/`var` ->
  `running_mean`/`running_var`;
- any other leaf (`bias`, TriPillarAggregator's `coord_w`/`hidden_b`)
  keeps its name and layout.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def load_variables_npz(path: str) -> Dict[str, np.ndarray]:
    """The flat '/'-joined arrays of an npz written by
    neo360_tpu/utils/io.py:save_variables_npz (whose load_variables_npz
    nests them; `from_flax_flat` takes them flat)."""
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


_STATS = {"mean": "running_mean", "var": "running_var"}


def from_flax_flat(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat Flax variables ('/'-joined keys under params/ and batch_stats/)
    -> the port's state_dict. Raises on a key it cannot convert."""
    sd: Dict[str, torch.Tensor] = {}
    unused = []
    for key, value in flat.items():
        coll, *path = key.split("/")
        leaf = path[-1] if path else ""
        arr = np.asarray(value, dtype=np.float32)
        if coll == "params" and leaf == "kernel" and arr.ndim in (2, 4):
            arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
            name = "weight"
        elif coll == "params" and leaf == "scale":
            name = "weight"
        elif coll == "params" and leaf in ("bias", "coord_w", "hidden_b"):
            name = leaf
        elif coll == "batch_stats" and leaf in _STATS:
            name = _STATS[leaf]
        else:
            unused.append(key)
            continue
        sd[".".join(path[:-1] + [name])] = torch.tensor(arr)
    if unused:
        raise KeyError(f"from_flax_flat: {len(unused)} keys not converted: "
                       f"{sorted(unused)[:10]}")
    return sd


def lpips_from_flax_flat(flat: Dict[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """The LPIPS npz of scripts/convert_weights.py (`params/vgg/conv{b}_{i}/
    kernel|bias`, HWIO kernels, and the lin weights `params/lin{i}`, (C,))
    -> nn.lpips.LPIPSModel's parameters (`vgg.conv{b}_{i}.weight` OIHW,
    `lin{i}`)."""
    lins = {k for k in flat if k.count("/") == 1 and
            k.startswith("params/lin")}
    sd = from_flax_flat({k: v for k, v in flat.items() if k not in lins})
    sd.update({k.split("/")[1]: torch.tensor(np.asarray(flat[k], np.float32))
               for k in lins})
    return sd


def from_checkpoint(raw: Dict) -> Dict[str, torch.Tensor]:
    """The state_dict in a port file: a training checkpoint
    (train/checkpoints.py, written by cli.run_train) gives its parameters
    (the stage trainer's two partitions merged, or the per-step trainer's
    one set) and BatchNorm buffers; anything else is taken to be a
    state_dict already."""
    if "enc_params" in raw:
        return {**raw["enc_params"], **raw["ray_params"],
                **raw["batch_stats"]}
    if "params" in raw and "batch_stats" in raw:
        return {**raw["params"], **raw["batch_stats"]}
    return raw


def load_into(model: nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """Copy `state_dict` into `model`; raise on any key the model does not
    have, any model entry left without a value, or a shape mismatch."""
    own = model.state_dict()
    unused = sorted(set(state_dict) - set(own))
    missing = sorted(set(own) - set(state_dict))
    if unused or missing:
        raise KeyError(f"weights do not fit the model: unused {unused[:10]} "
                       f"({len(unused)}), missing {missing[:10]} "
                       f"({len(missing)})")
    bad = [k for k, v in state_dict.items() if tuple(v.shape)
           != tuple(own[k].shape)]
    if bad:
        raise ValueError(f"shape mismatch: " + ", ".join(
            f"{k} {tuple(state_dict[k].shape)} vs {tuple(own[k].shape)}"
            for k in bad[:10]))
    model.load_state_dict(state_dict, strict=True)
