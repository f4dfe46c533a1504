"""Constants built once on their device.

A model's per-call constants (`pos_enc`'s scales, `linspace`'s values,
the latent grid's uv scales) are the same numbers every call. Built with
`torch.tensor([...], device="cuda")` they cost a copy from pageable host
memory, which waits for the stream to drain: the host stops until the
card has run all it was given, once a call. `cached(name, params, dtype,
device, build)` builds each one once, with the caller's own expression,
and returns that same tensor afterwards, so the values keep their bits.

An entry is keyed by its name, the Python values that fix it (`params`,
hashable), its dtype and its device with the index. It is built outside
inference mode and without grad: an inference-mode tensor that autograd
later saves for a backward raises, and one process may render (under
`torch.inference_mode`) and then train. Entries never require grad, and
callers never write into them.

`cached.builds` and `cached.hits` count the entries built and the
lookups served (`train/profiling.py:constant_counts`). One lock makes a
lookup, its count and a build one step, so threads share one tensor an
entry and lose no count (a build may look up another constant).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Hashable

import torch

_cache: Dict[tuple, torch.Tensor] = {}
_lock = threading.RLock()


def _device(device) -> torch.device:
    """`device` as a torch.device with its index (a CUDA device without
    one is the current device; None is the CPU)."""
    if isinstance(device, torch.device) and (device.index is not None
                                             or device.type != "cuda"):
        return device
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def cached(name: str, params: Hashable, dtype: torch.dtype, device,
           build: Callable[[], torch.Tensor]) -> torch.Tensor:
    """The constant `name` for `params` in `dtype` on `device`: `build()`
    the first time (it must make the tensor on that device in that dtype),
    the same tensor afterwards."""
    dev = _device(device)
    key = (name, params, dtype, dev)
    with _lock:
        out = _cache.get(key)
        if out is not None:
            cached.hits += 1
            return out
        with torch.inference_mode(False), torch.no_grad():
            out = build()
        if out.dtype != dtype or out.device != dev:
            raise ValueError(f"constant {name!r}: built {out.dtype} on "
                             f"{out.device}, keyed {dtype} on {dev}")
        _cache[key] = out
        cached.builds += 1
        return out


cached.builds = 0
cached.hits = 0
