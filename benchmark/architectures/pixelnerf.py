"""PixelNeRF as published (Yu et al. 2021, arXiv:2012.02190; pixel-nerf
conf/default_mv.conf) through the port's `pixelnerf` preset with
`mlp_type` "resnet", behind the adapter interface of the shared harness
(registry.py lists the interface and the rules).

The program is what the CLI's per-step trainer runs each step:
`cli.build_model` on the preset with the published network at the
configuration's sample counts and scenes a step, `cli.build_optimizer`, and
`loop.make_staged_trainer(loop.make_train_step(cli.make_loss_fn(cfg,
model), with_model_state=True))`, one step a call, as the NeO-360
adapter's "step" trainer runs. The program is checked against the
configuration's widths and constants when it is built, since the
reference (reference/pixelnerf.py) builds from the configuration alone.

Items: scenes.make_items' "stage" kind at K = 1 step of S scenes x B
rays (the configuration's scenes a step and rays of each), each scene with
its own 3 random source views; the K axis dropped, an item is one step's
batch, src (S, NV, ...) and rays (S, B / S, ...), and the pool is handed
on as "step" items, which the per-step trainer's spans are read from.

The port is imported inside the functions that drive it, never when this
module is loaded. No cell renders with this adapter: a view would run the
tile renderer again, which the NeO-360 render cell already measures.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from benchmark import check, scenes
from benchmark.architectures.neo360 import resnet34_macs
from benchmark.reference import pixelnerf as ref

# the roofline families (rooflines/<name>.py) of kernels A, A', D and D'
FAMILIES = ("pixel_latent_gather", "pixel_latent_transpose",
            "vanilla_composite", "vanilla_composite_transpose")
# the faults the reference plants in the program's place (control.py)
FAULTS = ref.FAULTS
# the model's constructor arguments the CPU tests narrow, and the CPU
# tests' sizes: a 5 x 32 ResnetFC, 8 + 4 + 4 samples, 2 scenes of 8 rays
# at 40x30
TINY_WIDTHS = {"d_hidden": 32, "num_fine_depth_samples": 4}
TINY = {"mlp_width": 32, "num_coarse_samples": 8, "num_fine_samples": 8,
        "num_fine_depth_samples": 4, "scenes_per_step": 2,
        "rays_per_scene": 8, "img_wh": [40, 30]}


def kernel_library() -> None:
    """Build (first run in a checkout) or load the port's kernels."""
    from neo360_tpu_torch.ops import kernels
    kernels.build()
    kernels.library()


def _program_constants(cfg, model) -> Dict:
    """The built program's widths and constants under the configuration's
    key names; the fine level's network is built as the coarse one's."""
    from neo360_tpu_torch.models import pixelnerf
    fc = model.coarse_mlp
    if [p.shape for p in fc.parameters()] != \
            [p.shape for p in model.fine_mlp.parameters()]:
        raise ValueError("the two levels' networks differ")
    return {
        "mlp_type": model.network, "num_src_views": model.num_src_views,
        "mlp_blocks": fc.n_blocks, "mlp_width": fc.lin_in.weight.shape[0],
        "combine_layer": fc.combine_layer, "lin_z": len(fc.lin_z),
        "d_in": fc.lin_in.weight.shape[1],
        "d_latent": fc.lin_z[0].weight.shape[1],
        "d_out": fc.lin_out.weight.shape[0],
        "pos_freqs": pixelnerf.PE_FREQS,
        "pos_freq_factor": pixelnerf.PE_FREQ_FACTOR,
        "latent_padding": model.padding,
        "num_coarse_samples": model.num_coarse_samples,
        "num_fine_samples": model.num_fine_samples,
        "num_fine_depth_samples": model.num_fine_depth_samples,
        "depth_std": pixelnerf.DEPTH_STD,
        "near": pixelnerf.NEAR, "far": pixelnerf.FAR,
        "white_bkgd": cfg.white_back,
        "precision": "bfloat16" if cfg.bf16 else "float32",
        "scenes_per_step": cfg.scenes_per_step,
        "rays_per_scene": cfg.ray_batch_size // cfg.scenes_per_step,
        "lr": cfg.lr_init if (cfg.lr_final == cfg.lr_init
                              and cfg.lr_delay_steps == 0) else None,
        "grad_max_norm": cfg.grad_max_norm}


class Program:
    def __init__(self, config: Dict, seed: int, device: torch.device,
                 generator_seed: int):
        from neo360_tpu_torch import cli
        from neo360_tpu_torch.config import preset
        scenes_per_step = config["scenes_per_step"]
        cfg = preset(
            "pixelnerf", seed=seed % 2 ** 31, device=str(device),
            mlp_type=config["mlp_type"],
            num_src_views=config["num_src_views"],
            num_coarse_samples=config["num_coarse_samples"],
            num_fine_samples=config["num_fine_samples"],
            scenes_per_step=scenes_per_step,
            ray_batch_size=scenes_per_step * config["rays_per_scene"],
            lr_init=config["lr"], lr_final=config["lr"], lr_delay_steps=0,
            grad_max_norm=config["grad_max_norm"],
            bf16=config["precision"] == "bfloat16")
        self.cfg = cfg
        self.device = device
        cli.float32_matmuls(cfg, device)
        self.model = cli.build_model(cfg, device)
        got = _program_constants(cfg, self.model)
        wrong = {k: (v, config.get(k)) for k, v in got.items()
                 if v != config.get(k)}
        if wrong:
            raise ValueError(f"the program differs from the configuration "
                             f"(program, configuration): {wrong}")
        self.generator = torch.Generator(device).manual_seed(generator_seed)
        self.runner = self.state = None
        self.recorded: List[torch.Tensor] = []
        self.recording = False

    def shapes(self) -> Dict[str, tuple]:
        return {k: tuple(v.shape) for k, v in self.model.state_dict().items()}

    def trained_names(self) -> List[str]:
        return [k for k, p in self.model.named_parameters()
                if p.requires_grad]

    def load(self, weights: Dict[str, torch.Tensor]) -> None:
        self.model.load_state_dict(weights, strict=True)

    def trainer_kind(self) -> str:
        return "per_step"

    def make_trainer(self) -> None:
        from neo360_tpu_torch import cli
        from neo360_tpu_torch.train import loop
        cfg, model = self.cfg, self.model
        model.train()
        self.state = loop.create_train_state(
            model, lambda params: cli.build_optimizer(cfg, params))
        step = loop.make_staged_trainer(loop.make_train_step(
            cli.make_loss_fn(cfg, model), with_model_state=True))

        def run(item):
            metrics = step(self.state, {k: item[k][None]
                                        for k in cli.STEP_KEYS},
                           self.generator)
            if self.recording:
                self.recorded.append(metrics["loss"].detach())
            return metrics
        self.runner = run

    def moments(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.state.params, self.state.opt.mu))

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach() for k, p in self.model.named_parameters()}

    def make_renderer(self, setup) -> None:
        raise NotImplementedError("no pixelnerf cell renders")

    def free(self) -> None:
        self.runner = self.state = self.model = None
        self.recorded = []


def make_items(mix: Dict, seed: int, device, cfg) -> Dict:
    """The mix's items: one step's batch of the program's scenes a step,
    each with its own source views and B / S rays, from a "stage" mix at
    K = 1; handed on as "step" items (the module docstring)."""
    if mix["kind"] != "stage":
        raise ValueError(f"mix {mix['name']} is {mix['kind']!r}; the "
                         f"pixelnerf adapter draws 'stage' items")
    pool = scenes.make_items(mix, seed, device, cfg.num_src_views,
                             steps=1, scenes_per_item=cfg.scenes_per_step,
                             rays_per_step=cfg.ray_batch_size)
    items = [{k: v if k in scenes.SRC_KEYS else v[0]
              for k, v in item.items()} for item in pool["items"]]
    return dict(pool, kind="step", items=items)


# ----------------------------------------------------------- the reference

def reference_train(config: Dict, weights: Dict[str, torch.Tensor],
                    trainer: str, items: List[Dict], gen_seed: int, device,
                    kind: str = "f32", fault=None) -> Dict:
    """The reference follows the program's first len(items) items from
    the same weights and generator seed: {"losses", "moments" (norms after
    the first item), "change" (norms of the change after the last)}."""
    tr = ref.Trainer(ref.Arch.from_config(config), weights, kind, fault)
    start = {k: v.detach().clone() for k, v in tr.params().items()}
    gen = torch.Generator(device).manual_seed(gen_seed)
    losses, moments = [], None
    for i, item in enumerate(items):
        losses.append(tr.step({k: v.to(device) for k, v in item.items()},
                              gen))
        if i == 0:
            moments = check.norms(tr.moments())
    change = check.norms({k: v - start[k] for k, v in tr.params().items()})
    return {"losses": losses, "moments": moments, "change": change}


def reference_render(config, weights, setup, rays, kind="f32", fault=None):
    raise NotImplementedError("no pixelnerf cell renders")


# ---------------------------------------------------------------- the work

@dataclass
class Work:
    """One training step: `scenes` scenes of `nv` source images (H, W)
    each, encoded to a (h, w) latent of `d_latent` channels; `rays` rays
    of each scene through each level's `samples`; the ResnetFC's sizes;
    `train`: gradients are taken."""
    scenes: int
    nv: int
    rays: int
    samples: Tuple[int, int]
    image_hw: Tuple[int, int]
    latent_hw: Tuple[int, int]
    d_in: int
    d_latent: int
    width: int
    blocks: int
    combine: int
    train: bool = True

    def points(self, level: int) -> int:
        """(sample, view) pairs of a level: the latent lookups."""
        return self.scenes * self.nv * self.rays * self.samples[level]


def work(config: Dict, mix: Dict, cfg) -> Work:
    w, h = mix["img_wh"]
    s = cfg.scenes_per_step
    coarse = config["num_coarse_samples"]
    return Work(scenes=s, nv=config["num_src_views"],
                rays=cfg.ray_batch_size // s,
                samples=(coarse, coarse + config["num_fine_samples"]),
                image_hw=(h, w), latent_hw=(h // 2, w // 2),
                d_in=config["d_in"], d_latent=config["d_latent"],
                width=config["mlp_width"], blocks=config["mlp_blocks"],
                combine=config["combine_layer"],
                train=mix["kind"] == "stage")


def resnetfc_macs(w: Work) -> int:
    """Multiply-adds of the ResnetFC at one sample: per view its input
    and latent layers and the blocks before the mean, per sample the
    blocks after it and the output layer."""
    per_view = (w.d_in * w.width + min(w.combine, w.blocks)
                * (w.d_latent * w.width + 2 * w.width * w.width))
    per_sample = max(w.blocks - w.combine, 0) * 2 * w.width * w.width
    return w.nv * per_view + per_sample + w.width * 4


def item_flops(w: Work) -> float:
    """The encoder on every source image and both levels' ResnetFC at
    every sample, two per multiply-add, three times the forward in
    training (forward, and the backward's two products)."""
    macs = w.scenes * w.nv * resnet34_macs(*w.image_hw)
    macs += w.scenes * w.rays * sum(w.samples) * resnetfc_macs(w)
    return 2.0 * macs * (3 if w.train else 1)


# -------------------------------------------------------------- CPU tests

def tiny_sizes(config: Dict) -> Dict:
    """The configuration keys the CPU tests replace."""
    return dict(TINY)


@contextlib.contextmanager
def tiny(config: Dict):
    """The port's model at TINY_WIDTHS while the block runs; yields
    `tiny_sizes(config)`."""
    from neo360_tpu_torch.models import pixelnerf
    saved = pixelnerf.PixelNeRF

    class Tiny(saved):
        __init__ = functools.partialmethod(saved.__init__, **TINY_WIDTHS)

    pixelnerf.PixelNeRF = Tiny
    try:
        yield tiny_sizes(config)
    finally:
        pixelnerf.PixelNeRF = saved
