"""Host-side output helpers (port of neo360_tpu/utils/io.py:to8b,
write_stats)."""

from __future__ import annotations

import json
import os

import numpy as np


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(np.asarray(x), 0.0, 1.0)).astype(np.uint8)


def write_stats(path: str, **metric_groups) -> str:
    """results.json writer: scalars, strings, {name: value} dicts and lists
    of floats."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {}
    for name, values in metric_groups.items():
        if values is None:
            continue
        if isinstance(values, str):
            payload[name] = values
        elif isinstance(values, dict):
            payload[name] = {k: (float(v) if np.ndim(v) == 0 else
                                 [float(e) for e in np.ravel(v)])
                             for k, v in values.items()}
        elif np.ndim(values) == 0:
            payload[name] = float(values)
        else:
            payload[name] = [float(v) for v in np.ravel(values)]
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    return path
