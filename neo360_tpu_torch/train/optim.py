"""Adam with per-partition global-norm clipping, in the arithmetic of
`optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(schedule))`,
the optimizer of neo360_tpu/cli.py:build_optimizer.

- Clipping scales by max_norm / ||g|| only when ||g|| >= max_norm, with no
  epsilon (torch's `clip_grad_norm_` adds 1e-6 to the norm).
- The schedule is read at the update count *before* it is incremented, so
  the first update uses schedule(0).
- Moments: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, bias
  corrected with 1 - b^count after the increment; the step is
  -lr * mu_hat / (sqrt(nu_hat) + eps).

The parameters are updated in place with `torch._foreach_*` ops, a handful
of launches per step whatever the number of tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Union

import numpy as np
import torch


class Adam:
    def __init__(self, params: Sequence[torch.Tensor],
                 schedule: Union[float, Callable[[int], float]],
                 max_norm: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params: List[torch.Tensor] = list(params)
        self.schedule = schedule
        self.max_norm, self.b1, self.b2, self.eps = max_norm, b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def lr(self, count: int) -> float:
        s = self.schedule
        return float(s(count)) if callable(s) else float(s)

    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax.clip_by_global_norm: g unchanged below max_norm, else
        g / ||g|| * max_norm (no host round trip: the choice is a where)."""
        if self.max_norm <= 0:
            return grads
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                            self.max_norm / norm)
        return torch._foreach_mul(grads, scale)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update of every parameter from `grads` (same order)."""
        grads = [g.float() for g in grads]
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        grads = self.clip(grads)
        lr = self.lr(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(b2) ** f32(self.count))
        denom = torch._foreach_add(torch._foreach_sqrt(
            torch._foreach_div(self.nu, bc2)), self.eps)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        torch._foreach_add_(self.params, torch._foreach_mul(upd, -lr))

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": [m.clone() for m in self.mu],
                "nu": [n.clone() for n in self.nu]}

    def load_state_dict(self, state: Dict) -> None:
        if len(state["mu"]) != len(self.params):
            raise ValueError("optimizer state does not fit the parameters")
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
            dst.copy_(src)
