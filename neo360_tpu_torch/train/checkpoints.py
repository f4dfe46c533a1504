"""Checkpoints with the JAX package's retention policy (port of
neo360_tpu/train/checkpoints.py), written with `torch.save`.

A checkpoint is one file, `ckpt_<step:08d>.pt`, holding what the caller
gives `save` (the stage trainer: both parameter partitions, both Adam
states, the step and the BatchNorm buffers) and the metrics it was saved
with. Retention: the newest checkpoint plus the MAX_TO_KEEP best by
val_psnr (higher is better), as the reference's save_last + top-k; with
`keep_all` (optimize runs) every checkpoint.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r"^ckpt_(\d{8})\.pt$")
MAX_TO_KEEP = 5
MONITOR = "val_psnr"


class CheckpointManager:
    def __init__(self, directory: str, keep_all: bool = False):
        self.directory = os.path.abspath(directory)
        self.keep_all = keep_all

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _metrics_path(self) -> str:
        return os.path.join(self.directory, "metrics.json")

    def _metrics(self) -> Dict[str, Dict[str, float]]:
        try:
            with open(self._metrics_path()) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}

    def save(self, step: int, payload: Dict[str, Any],
             metrics: Optional[Dict[str, float]] = None) -> str:
        """Write `payload` as the checkpoint of `step` (atomically), then
        drop the checkpoints the retention policy does not keep."""
        os.makedirs(self.directory, exist_ok=True)
        path = self.path(step)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        table = self._metrics()
        table[str(step)] = {k: float(v) for k, v in (metrics or {}).items()}
        steps = self.steps()
        score = lambda s: table.get(str(s), {}).get(MONITOR, -1e30)
        keep = set(steps if self.keep_all else
                   sorted(steps, key=score, reverse=True)[:MAX_TO_KEEP])
        keep.add(steps[-1])
        for s in steps:
            if s not in keep:
                os.remove(self.path(s))
                table.pop(str(s), None)
        with open(self._metrics_path(), "w") as f:
            json.dump(table, f)
        return path

    def restore(self) -> Optional[Dict]:
        """The newest checkpoint's payload, on the CPU, or None when there
        is none."""
        step = self.latest_step()
        if step is None:
            return None
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)
