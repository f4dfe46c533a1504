"""The training semantics the reference follows, in plain PyTorch: Adam
after a global-norm clip (optax's chain: scale by max_norm / ||g|| only
when ||g|| >= max_norm; moments bias-corrected after the count's
increment; the learning rate read at the count before it), the NeRF
learning-rate schedule, and the two trainers of NeO-360:

- per step: encode the step's source views (BatchNorm on the batch),
  render its rays, differentiate the loss with respect to every
  parameter, one clipped Adam step;
- scene-mixed encode-once stage: encode each of the stage's S scenes
  once, then K steps that each differentiate the loss (the mean over the
  scenes of each scene's loss) with respect to the ray-branch parameters
  and to the detached encodings, step the ray optimizer and add the
  encodings' gradients up; after the K steps the mean gradient is pulled
  back through the encoder and its optimizer steps once. Parameter names
  starting with "encoder." or "local_proj" form the encoder partition.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from benchmark.reference import model as ref

SRC_KEYS = ("src_imgs", "src_poses", "src_focal", "src_c")
RAY_KEYS = ("rays_o", "rays_d", "viewdirs", "target")


def nerf_schedule(lr_init=5e-4, lr_final=5e-6, max_steps=100000,
                  delay_steps=2500, delay_mult=0.01) -> Callable[[int],
                                                                 float]:
    """Sine warm-up delay times a log-linear decay, in float32."""
    f32 = np.float32

    def lr(step: int) -> float:
        step = f32(step)
        frac = np.clip(step / f32(delay_steps), f32(0), f32(1))
        delay = f32(delay_mult) + f32(1 - delay_mult) * np.sin(
            f32(0.5 * np.pi) * frac)
        t = np.clip(step / f32(max_steps), f32(0), f32(1))
        decay = np.exp(f32(np.log(f32(lr_init))) * (f32(1) - t)
                       + f32(np.log(f32(lr_final))) * t)
        return float(f32(delay * decay))
    return lr


class Adam:
    def __init__(self, params: List[torch.Tensor], max_norm: float,
                 schedule: Callable[[int], float], b1=0.9, b2=0.999,
                 eps=1e-8):
        self.params, self.max_norm, self.schedule = params, max_norm, schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                            self.max_norm / norm)
        lr = self.schedule(self.count)
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(self.count))
        for p, m, v, g in zip(self.params, self.mu, self.nu, grads):
            g = g * scale
            m.mul_(self.b1).add_(g * (1 - self.b1))
            v.mul_(self.b2).add_(g * g * (1 - self.b2))
            p.add_((m / bc1) / (torch.sqrt(v / bc2) + self.eps) * -lr)


def _grads(loss, params):
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(gs, params)]


class Trainer:
    """The reference's copy of a training state: float32 leaves by the
    program's parameter names, one optimizer (per step) or one per
    partition (stage). `step(item, gen)` runs one item and returns the
    loss of each of its ray steps."""

    def __init__(self, arch: ref.Arch, weights: Dict[str, torch.Tensor],
                 trainer: str, max_norm: float = 0.05,
                 prec: ref.Precision = None, schedule=None):
        self.arch, self.kind = arch, trainer
        self.prec = prec or ref.Precision()
        self.W = {k: v.detach().float().clone().requires_grad_()
                  for k, v in weights.items()}
        schedule = schedule or nerf_schedule()
        names = list(self.W)
        if trainer == "per_step":
            self.groups = {"all": names}
        else:
            is_enc = lambda n: n.startswith(("encoder.", "local_proj"))
            self.groups = {"enc": [n for n in names if is_enc(n)],
                           "ray": [n for n in names if not is_enc(n)]}
        self.opts = {g: Adam([self.W[n] for n in ns], max_norm, schedule)
                     for g, ns in self.groups.items()}

    def moments(self) -> Dict[str, torch.Tensor]:
        """Each leaf's first moment, by name."""
        return {n: m for g, ns in self.groups.items()
                for n, m in zip(ns, self.opts[g].mu)}

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.W.items()}

    def _scene_loss(self, enc, src, batch, gen, scene=0):
        if self.prec.fault == "half":       # half of the rays left out
            n = batch["rays_o"].shape[0] // 2
            batch = {k: v[:n] for k, v in batch.items()}
        rays = {k: batch[k] for k in ("rays_o", "rays_d", "viewdirs")}
        out = ref.render_rays(self.W, self.prec, self.arch, enc, src, rays,
                              gen, scene)
        return ref.loss(self.arch, out, batch["target"])[0]

    def step(self, item: Dict[str, torch.Tensor], gen) -> List[float]:
        if self.kind == "per_step":
            src = {k: item[k] for k in SRC_KEYS}
            enc = [ref.encode(self.W, self.prec, self.arch, src)]
            loss = self._scene_loss(enc, src, item, gen)
            names = self.groups["all"]
            self.opts["all"].step(_grads(loss, [self.W[n] for n in names]))
            return [float(loss.detach())]
        return self._stage(item, gen)

    def _stage(self, item, gen) -> List[float]:
        mixed = item["src_imgs"].dim() == 5
        n_scenes = item["src_imgs"].shape[0] if mixed else 1
        srcs = [{k: (item[k][i] if mixed else item[k])
                 for k in SRC_KEYS} for i in range(n_scenes)]
        encs = [ref.encode(self.W, self.prec, self.arch, s) for s in srcs]
        flat = [t for planes, local in encs for t in (*planes, *local)]
        leaves = [t.detach().requires_grad_() for t in flat]
        per = len(flat) // n_scenes
        det = []
        for i in range(n_scenes):
            ts = leaves[i * per:(i + 1) * per]
            det.append((tuple(ts[:3]), list(ts[3:])))
        ray_names = self.groups["ray"]
        ray_params = [self.W[n] for n in ray_names]
        cot = [torch.zeros_like(t) for t in leaves]
        k_steps = item["rays_o"].shape[0]
        losses = []
        for i in range(k_steps):
            parts = []
            for s in range(n_scenes):
                batch = {k: (item[k][i][s] if mixed else item[k][i])
                         for k in RAY_KEYS}
                parts.append(self._scene_loss(det, srcs[s], batch, gen, s))
            loss = torch.stack(parts).mean()
            gs = _grads(loss, ray_params + leaves)
            self.opts["ray"].step(gs[:len(ray_params)])
            for c, g in zip(cot, gs[len(ray_params):]):
                c.add_(g)
            losses.append(float(loss.detach()))
        enc_names = self.groups["enc"]
        enc_params = [self.W[n] for n in enc_names]
        g_enc = torch.autograd.grad(flat, enc_params,
                                    [c / k_steps for c in cot],
                                    allow_unused=True)
        self.opts["enc"].step([torch.zeros_like(p) if g is None else g
                               for g, p in zip(g_enc, enc_params)])
        return losses

