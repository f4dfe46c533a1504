"""MipNeRF-360 (arXiv:2111.12077) through the port's `mipnerf360` preset,
behind the adapter interface of the shared harness (registry.py lists the
interface and the rules).

The program is what the CLI's single-scene trainer runs each step:
`cli.build_model` on the preset at the configuration's batch and sample
counts, `cli.build_optimizer`, and `loop.make_train_step(
cli.make_loss_fn(cfg, model), with_step=True)`, the step that
`cli._run_train_buffers` wraps in `make_buffer_trainer`. Each "rays" item
is one step's batch (rays with their targets and cone radii), copied to
the card inside the window; the step count before each step anneals the
resampling. The program is checked against the configuration's widths
and constants when it is built, since the reference
(reference/mipnerf360.py) builds from the configuration alone.

The port is imported inside the functions that drive it, never when this
module is loaded. No cell renders with this adapter: a view would run
`make_image_renderer` again, which the NeO-360 render cell already
measures.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from benchmark import check, scenes
from benchmark.reference import mipnerf360 as ref

# the roofline families (rooflines/<name>.py) of kernels E and E'
FAMILIES = ("mip_composite", "mip_composite_transpose")
# the faults the reference plants in the program's place (control.py)
FAULTS = ("half", "jacobian")
STEP_KEYS = ("rays_o", "rays_d", "viewdirs", "radii", "target")
# the model's constructor arguments the CPU tests narrow (the port's own
# CPU tests' widths)
TINY_WIDTHS = {"nerf_netwidth": 32, "prop_netdepth": 2, "prop_netwidth": 32}
TINY = dict(TINY_WIDTHS, num_prop_samples=8, num_nerf_samples=4,
            batch_size=16, img_wh=[40, 30])


def kernel_library() -> None:
    """Build (first run in a checkout) or load the port's kernels."""
    from neo360_tpu_torch.ops import kernels
    kernels.build()
    kernels.library()


def _program_constants(cfg, model) -> Dict[str, float]:
    """The built program's widths and constants under the configuration's
    key names."""
    from neo360_tpu_torch import cli
    nerf, prop = model.nerf_mlp, model.prop_mlp_0
    return {
        "prop_levels": model.num_levels - 1,
        "num_prop_samples": model.num_prop_samples,
        "num_nerf_samples": model.num_nerf_samples,
        "prop_netdepth": prop.netdepth,
        "prop_netwidth": prop.pts_0.weight.shape[0],
        "nerf_netdepth": nerf.netdepth,
        "nerf_netwidth": nerf.pts_0.weight.shape[0],
        "skip_layer": nerf.skip_layer,
        "bottleneck_width": nerf.bottleneck_width,
        "view_width": nerf.netwidth_condition,
        "basis_vectors": nerf.pos_basis.shape[1],
        "min_deg_point": nerf.min_deg_point,
        "max_deg_point": nerf.max_deg_point,
        "ipe_features": nerf.pts_0.weight.shape[1],
        "deg_view": nerf.deg_view,
        "near": cli.SCENE_NEAR, "far": cli.SCENE_FAR,
        "dilation_multiplier": model.dilation_multiplier,
        "dilation_bias": model.dilation_bias,
        "anneal_slope": model.anneal_slope,
        "anneal_steps": cli.MIP_ANNEAL_STEPS,
        "density_bias": nerf.density_bias, "rgb_padding": nerf.rgb_padding,
        "background": model.bg_intensity,
        "batch_size": cfg.batch_size, "lr_init": cfg.lr_init,
        "lr_final": cfg.lr_final, "lr_max_steps": cfg.run_max_steps,
        "lr_delay_steps": cfg.lr_delay_steps,
        "lr_delay_mult": cfg.lr_delay_mult,
        "grad_max_norm": cfg.grad_max_norm}


class Program:
    def __init__(self, config: Dict, seed: int, device: torch.device,
                 generator_seed: int):
        from neo360_tpu_torch import cli
        from neo360_tpu_torch.config import preset
        if config["precision"] != "float32":
            raise ValueError(f"the mipnerf360 preset trains in float32, "
                             f"not {config['precision']}")
        cfg = preset("mipnerf360", seed=seed % 2 ** 31, device=str(device),
                     batch_size=config["batch_size"],
                     num_prop_samples=config["num_prop_samples"],
                     num_fine_samples=config["num_nerf_samples"])
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
        step = loop.make_train_step(cli.make_loss_fn(cfg, model),
                                    with_step=True)

        def run(item):
            metrics = step(self.state, {k: item[k] for k in STEP_KEYS},
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
        raise NotImplementedError("no mipnerf360 cell renders")

    def free(self) -> None:
        self.runner = self.state = self.model = None
        self.recorded = []


def make_items(mix: Dict, seed: int, device, cfg) -> Dict:
    """The mix's items (scenes.make_items): one step's batch of the
    program's B rays an item; only "rays" mixes."""
    if mix["kind"] != "rays":
        raise ValueError(f"mix {mix['name']} is {mix['kind']!r}; the "
                         f"mipnerf360 adapter runs 'rays' items")
    return scenes.make_items(mix, seed, device, 0,
                             rays_per_step=cfg.batch_size)


# ----------------------------------------------------------- the reference

def reference_train(config: Dict, weights: Dict[str, torch.Tensor],
                    trainer: str, items: List[Dict], gen_seed: int, device,
                    kind: str = "f32", fault=None) -> Dict:
    """The reference follows the program's first len(items) items from
    the same weights and generator seed: {"losses", "moments" (norms after
    the first item), "change" (norms of the change after the last)}."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")
    tr = ref.Trainer(ref.Arch.from_config(config), weights, kind, fault)
    start = {k: v.detach().clone() for k, v in tr.params().items()}
    gen = torch.Generator(device).manual_seed(gen_seed)
    losses, moments = [], None
    for i, item in enumerate(items):
        losses.append(tr.step({k: item[k].to(device) for k in STEP_KEYS},
                              gen))
        if i == 0:
            moments = check.norms(tr.moments())
    change = check.norms({k: v - start[k] for k, v in tr.params().items()})
    return {"losses": losses, "moments": moments, "change": change}


def reference_render(config, weights, setup, rays, kind="f32", fault=None):
    raise NotImplementedError("no mipnerf360 cell renders")


# ---------------------------------------------------------------- the work

@dataclass
class Work:
    """One training step: `rays` rays through each level's `intervals`
    (the two proposal levels, then the NeRF level), and the MLPs' sizes;
    `train`: gradients are taken."""
    rays: int
    intervals: Tuple[int, ...]
    prop_netdepth: int
    prop_netwidth: int
    nerf_netdepth: int
    nerf_netwidth: int
    skip_layer: int
    bottleneck_width: int
    view_width: int
    ipe_features: int
    dir_features: int
    train: bool = True


def work(config: Dict, mix: Dict, cfg) -> Work:
    prop = [config["num_prop_samples"]] * config["prop_levels"]
    return Work(rays=cfg.batch_size,
                intervals=tuple(prop + [config["num_nerf_samples"]]),
                prop_netdepth=config["prop_netdepth"],
                prop_netwidth=config["prop_netwidth"],
                nerf_netdepth=config["nerf_netdepth"],
                nerf_netwidth=config["nerf_netwidth"],
                skip_layer=config["skip_layer"],
                bottleneck_width=config["bottleneck_width"],
                view_width=config["view_width"],
                ipe_features=config["ipe_features"],
                dir_features=3 * (1 + 2 * config["deg_view"]),
                train=mix["kind"] == "rays")


def trunk_macs(inputs: int, depth: int, width: int, skip: int):
    """(multiply-adds a sample, the width it ends at) of a ReLU trunk that
    takes the input again after every skip-th layer, with its density
    head."""
    macs, fan_in = 0, inputs
    for i in range(depth):
        macs += fan_in * width
        fan_in = width + (inputs if i > 0 and i % skip == 0 else 0)
    return macs + fan_in, fan_in


def item_flops(w: Work) -> float:
    """The three MLPs at every interval of their level, two per
    multiply-add, three times the forward in training (forward, and the
    backward's two products)."""
    prop, _ = trunk_macs(w.ipe_features, w.prop_netdepth, w.prop_netwidth,
                         w.skip_layer)
    nerf, fan_in = trunk_macs(w.ipe_features, w.nerf_netdepth,
                              w.nerf_netwidth, w.skip_layer)
    nerf += (fan_in * w.bottleneck_width
             + (w.bottleneck_width + w.dir_features) * w.view_width
             + w.view_width * 3)
    macs = w.rays * (sum(w.intervals[:-1]) * prop + w.intervals[-1] * nerf)
    return 2.0 * macs * (3 if w.train else 1)


# -------------------------------------------------------------- CPU tests

def tiny_sizes(config: Dict) -> Dict:
    """The configuration keys the CPU tests replace."""
    return dict(TINY)


@contextlib.contextmanager
def tiny(config: Dict):
    """The port's model at TINY's widths while the block runs; yields
    `tiny_sizes(config)`."""
    from neo360_tpu_torch.models import mipnerf360
    saved = mipnerf360.MipNeRF360

    class Tiny(saved):
        __init__ = functools.partialmethod(saved.__init__, **TINY_WIDTHS)

    mipnerf360.MipNeRF360 = Tiny
    try:
        yield tiny_sizes(config)
    finally:
        mipnerf360.MipNeRF360 = saved
