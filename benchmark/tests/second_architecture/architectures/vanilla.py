"""Vanilla NeRF (arXiv:2003.08934) through the port's `vanilla` preset: an
adapter written as a later architecture's would be (registry.py lists the
interface), which test_bench_architectures.py drops into a copy of the
benchmark with its configuration, traffic, limits and roofline family.

The program is the port's per-step path: `cli.build_model`,
`cli.make_loss_fn`, `loop.make_train_step` (one step a "rays" item) and
`loop.make_image_renderer` (one "image" view a call, no source stack).
The reference is the port's own model on its plain path, built apart from
the program and stepped by a plain loop (the loss, `autograd.grad`, the
CLI's Adam), so it shows that the harness hands both sides the same
weights, items and draws, and not that the port is right: a cell of
BENCHMARK.json brings a plain reference of its own (reference/).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from benchmark import check, scenes

FAMILIES = ("vanilla_composite",)
FAULTS = ("half", "rgb")
SIZE_KEYS = ("num_coarse_samples", "num_fine_samples", "batch_size",
             "chunk")
STEP_KEYS = ("rays_o", "rays_d", "viewdirs", "target")
TINY = {"num_coarse_samples": 8, "num_fine_samples": 8, "batch_size": 16,
        "img_wh": [40, 30]}


def kernel_library() -> None:
    from neo360_tpu_torch.ops import kernels
    kernels.build()
    kernels.library()


def _cfg(config, seed, device):
    from neo360_tpu_torch.config import preset
    sizes = {k: config[k] for k in SIZE_KEYS if k in config}
    return preset("vanilla", seed=seed % 2 ** 31, device=str(device),
                  **sizes)


def _model(cfg, device, weights=None):
    from neo360_tpu_torch import cli
    model = cli.build_model(cfg, device)
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    return model


class Program:
    def __init__(self, config, seed, device, generator_seed):
        from neo360_tpu_torch import cli
        self.cfg = _cfg(config, seed, device)
        cli.float32_matmuls(self.cfg, device)
        self.model = _model(self.cfg, device)
        self.generator = torch.Generator(device).manual_seed(generator_seed)
        self.runner = self.state = None
        self.recorded = []
        self.recording = False

    def shapes(self):
        return {k: tuple(v.shape) for k, v in self.model.state_dict().items()}

    def trained_names(self):
        return [k for k, p in self.model.named_parameters()
                if p.requires_grad]

    def load(self, weights):
        self.model.load_state_dict(weights, strict=True)

    def trainer_kind(self):
        return "per_step"

    def make_trainer(self):
        from neo360_tpu_torch import cli
        from neo360_tpu_torch.train import loop
        cfg, model = self.cfg, self.model
        model.train()
        self.state = loop.create_train_state(
            model, lambda params: cli.build_optimizer(cfg, params))
        step = loop.make_staged_trainer(loop.make_train_step(
            cli.make_loss_fn(cfg, model)))

        def run(item):
            metrics = step(self.state, {k: item[k][None] for k in STEP_KEYS},
                           self.generator)
            if self.recording:
                self.recorded.append(metrics["loss"].detach())
            return metrics
        self.runner = run

    def moments(self):
        return dict(zip(self.state.params, self.state.opt.mu))

    def params(self):
        return {k: p.detach() for k, p in self.model.named_parameters()}

    def make_renderer(self, setup):
        from neo360_tpu_torch import cli
        from neo360_tpu_torch.train import loop
        cfg, model = self.cfg, self.model
        model.eval()

        def render_chunk(_, rays):
            out = model(rays, cfg.white_back, cli.SCENE_NEAR,
                        cli.SCENE_FAR)[1]
            return {"rgb": out["rgb"], "depth": out["depth"]}

        renderer = loop.make_image_renderer(render_chunk, cfg.chunk)
        self.runner = lambda rays: renderer(None, rays)

    def free(self):
        self.runner = self.state = self.model = None
        self.recorded = []


def make_items(mix, seed, device, cfg):
    return scenes.make_items(mix, seed, device, 0,
                             rays_per_step=cfg.batch_size)


@contextlib.contextmanager
def _precision(kind):
    """TF32 for matmuls under the "tf32" control, off otherwise."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = kind == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def reference_train(config, params, trainer, items, gen_seed, device,
                    kind="f32", fault=None):
    from neo360_tpu_torch import cli
    cfg = _cfg(config, 0, device)
    model = _model(cfg, device, params).train()
    names = [k for k, p in model.named_parameters() if p.requires_grad]
    leaves = [dict(model.named_parameters())[k] for k in names]
    opt = cli.build_optimizer(cfg, leaves)
    loss_fn = cli.make_loss_fn(cfg, model)
    start = [p.detach().clone() for p in leaves]
    gen = torch.Generator(device).manual_seed(gen_seed)
    losses, moments = [], None
    with _precision(kind):
        for i, item in enumerate(items):
            batch = {k: item[k].to(device) for k in STEP_KEYS}
            if fault == "half":
                batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            loss, _ = loss_fn(batch, gen)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            opt.step([torch.zeros_like(p) if g is None else g
                      for g, p in zip(grads, leaves)])
            losses.append(float(loss.detach()))
            if i == 0:
                moments = check.norms(dict(zip(names, opt.mu)))
    change = check.norms({k: p.detach() - s
                          for k, p, s in zip(names, leaves, start)})
    return {"losses": losses, "moments": moments, "change": change}


def reference_render(config, params, setup, rays, kind="f32", fault=None):
    from neo360_tpu_torch import cli
    device = rays["rays_o"].device
    cfg = _cfg(config, 0, device)
    model = _model(cfg, device, params).eval()
    n = rays["rays_o"].shape[0]
    with torch.no_grad(), _precision(kind):
        outs = [model({k: v[i:i + cfg.chunk] for k, v in rays.items()},
                      cfg.white_back, cli.SCENE_NEAR, cli.SCENE_FAR)[1]
                for i in range(0, n, cfg.chunk)]
    out = {k: torch.cat([o[k] for o in outs]) for k in ("rgb", "depth")}
    if fault == "rgb":
        out["rgb"] = out["rgb"] + 0.05
    return out


@dataclass
class Work:
    """One item: `batches` ray batches of `rays` rays, each through the
    two levels' `samples`; `train`: gradients are taken."""
    rays: int
    batches: int
    samples: tuple
    train: bool


def work(config, mix, cfg):
    n0 = cfg.num_coarse_samples + 1
    levels = (n0, n0 + cfg.num_fine_samples)
    if mix["kind"] == "rays":
        return Work(cfg.batch_size, 1, levels, True)
    w, h = mix["img_wh"]
    return Work(cfg.chunk, -(-w * h // cfg.chunk), levels, False)


def item_flops(w):
    """The NeRF MLP (8 x 256, the input again after layer 4, a 128-wide
    view branch) at every sample of both levels, two per multiply-add,
    three times the forward in training."""
    pe, vd = 63, 27
    per_sample = (pe * 256 + 4 * 256 * 256 + (256 + pe) * 256
                  + 2 * 256 * 256 + 256 + 256 * 256 + (256 + vd) * 128
                  + 128 * 3)
    macs = w.batches * w.rays * sum(w.samples) * per_sample
    return 2.0 * macs * (3 if w.train else 1)


def tiny_sizes(config):
    return dict(TINY)


@contextlib.contextmanager
def tiny(config):
    yield tiny_sizes(config)
