"""Learning-rate schedules (port of neo360_tpu/train/schedules.py:15-28).

`nerf_schedule`: a warm-up sine delay times a log-space lerp from lr_init
to lr_final, as a plain callable step -> lr evaluated in float32, as the
JAX schedule traces it.
"""

from __future__ import annotations

import numpy as np


def nerf_schedule(lr_init: float, lr_final: float, max_steps: int,
                  delay_steps: int = 2500, delay_mult: float = 0.01):
    f32 = np.float32

    def schedule(step) -> float:
        step = f32(step)
        if delay_steps > 0:
            frac = np.clip(step / f32(delay_steps), f32(0), f32(1))
            delay_rate = f32(delay_mult) + f32(1.0 - delay_mult) * np.sin(
                f32(0.5 * np.pi) * frac)
        else:
            delay_rate = f32(1.0)
        t = np.clip(step / f32(max_steps), f32(0), f32(1))
        scaled = np.exp(f32(np.log(f32(lr_init))) * (f32(1) - t)
                        + f32(np.log(f32(lr_final))) * t)
        return float(f32(delay_rate * scaled))
    return schedule
