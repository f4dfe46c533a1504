"""Training scalars as JSON lines and validation images as PNGs (port of
neo360_tpu/train/logging.py:MetricsLogger, without the optional W&B
mirror): `<log_dir>/metrics.jsonl` gets one record per `log` call,
{"step", "time", metric: value, ...}, the JAX logger's format."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def log_image(self, step: int, name: str, image) -> str:
        """Save an (H, W, 3) float image as <name>_<step:08d>.png beside
        the metrics file."""
        from PIL import Image

        from neo360_tpu_torch.utils.io import to8b
        path = os.path.join(os.path.dirname(self.path),
                            f"{name}_{step:08d}.png")
        Image.fromarray(to8b(image)).save(path)
        return path

    def close(self) -> None:
        self._f.close()
