"""Vanilla NeRF as published (Mildenhall et al. 2020, arXiv:2003.08934)
through the port's `vanilla` preset, behind the adapter interface of the
shared harness (registry.py lists the interface and the rules).

The program is what the CLI renders a view with (`--exp_type vanilla
--eval_mode full_eval`): `cli.build_model` on the preset at the
configuration's sample counts and tile, TF32 off (`cli.float32_matmuls`),
and `loop.make_image_renderer` over `cli.scene_render_chunk`, the fine
level's rgb, depth and acc in tiles of `chunk` rays (on the card the
unmarked tiles replay the renderer's CUDA graph). No encoder and no pack:
the model is fitted to one scene. The program is checked against the
configuration's widths and constants when it is built, since the
reference (reference/vanilla.py) builds from the configuration alone.

Items: scenes.make_items' "image" kind, whole orbit views with no source
stack, one ray a pixel (rays_o, rays_d, viewdirs; the pixel radii, which
only MipNeRF reads, are left out). No cell trains with this adapter: the
MipNeRF-360 training cell already runs the 256-wide f32 GEMMs and their
transposes of a per-scene trainer.

The port is imported inside the functions that drive it, never when this
module is loaded.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from benchmark import scenes
from benchmark.reference import vanilla as ref

# the roofline family (rooflines/<name>.py) of kernel D, the view's only
# hand-written kernel
FAMILIES = ("vanilla_composite",)
# the faults the reference plants in the program's place (control.py)
FAULTS = ref.FAULTS
REF_CHUNK = 1024
# the CPU tests' sizes: a 2 x 32 trunk with its skip after the second
# layer, a 16-wide view branch, 8 + 8 samples, 40x30 views in 256-ray
# tiles
TINY_WIDTHS = {"netdepth": 2, "netwidth": 32, "skip_layer": 1,
               "netwidth_condition": 16}
TINY = dict(TINY_WIDTHS, num_coarse_samples=8, num_fine_samples=8,
            chunk=256, img_wh=[40, 30])


def kernel_library() -> None:
    """Build (first run in a checkout) or load the port's kernels."""
    from neo360_tpu_torch.ops import kernels
    kernels.build()
    kernels.library()


def _program_constants(cfg, model) -> Dict:
    """The built program's widths and constants under the configuration's
    key names; the fine level's MLP is built as the coarse one's."""
    from neo360_tpu_torch.data import nerds360
    mlp = model.coarse_mlp
    if [p.shape for p in mlp.parameters()] != \
            [p.shape for p in model.fine_mlp.parameters()]:
        raise ValueError("the two levels' MLPs differ")
    return {
        "netdepth": mlp.netdepth, "netwidth": mlp.pts_0.weight.shape[0],
        "skip_layer": mlp.skip_layer,
        "netdepth_condition": mlp.netdepth_condition,
        "netwidth_condition": mlp.views_0.weight.shape[0],
        "min_deg_point": model.min_deg_point,
        "max_deg_point": model.max_deg_point, "deg_view": model.deg_view,
        "num_coarse_samples": model.num_coarse_samples,
        "num_fine_samples": model.num_fine_samples,
        "rgb_padding": model.rgb_padding, "sigma_bias": model.sigma_bias,
        "near": nerds360.NEAR, "far": nerds360.FAR,
        "white_bkgd": cfg.white_back, "chunk": cfg.chunk,
        "precision": "bfloat16" if mlp.pts_0.dtype == torch.bfloat16
        else "float32"}


class Program:
    def __init__(self, config: Dict, seed: int, device: torch.device,
                 generator_seed: int):
        from neo360_tpu_torch import cli
        from neo360_tpu_torch.config import preset
        cfg = preset("vanilla", seed=seed % 2 ** 31, device=str(device),
                     num_coarse_samples=config["num_coarse_samples"],
                     num_fine_samples=config["num_fine_samples"],
                     chunk=config["chunk"],
                     bf16=config["precision"] == "bfloat16")
        self.cfg, self.cli, self.device = cfg, cli, device
        cli.float32_matmuls(cfg, device)
        self.model = cli.build_model(cfg, device)
        got = _program_constants(cfg, self.model)
        wrong = {k: (v, config.get(k)) for k, v in got.items()
                 if v != config.get(k)}
        if wrong:
            raise ValueError(f"the program differs from the configuration "
                             f"(program, configuration): {wrong}")
        self.runner = None

    def shapes(self) -> Dict[str, tuple]:
        return {k: tuple(v.shape) for k, v in self.model.state_dict().items()}

    def trained_names(self):
        return [k for k, p in self.model.named_parameters()
                if p.requires_grad]

    def load(self, weights: Dict[str, torch.Tensor]) -> None:
        self.model.load_state_dict(weights, strict=True)

    def trainer_kind(self) -> str:
        return "ray_buffer"

    def make_trainer(self) -> None:
        raise NotImplementedError("no vanilla cell trains")

    def moments(self):
        raise NotImplementedError("no vanilla cell trains")

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach() for k, p in self.model.named_parameters()}

    def make_renderer(self, setup) -> None:
        """Bind the tile renderer; a per-scene model has no set-up."""
        from neo360_tpu_torch.train import loop
        if setup is not None:
            raise ValueError("a vanilla NeRF renders with no source stack")
        cli, cfg = self.cli, self.cfg
        self.model.eval()
        renderer = loop.make_image_renderer(
            cli.scene_render_chunk(cfg, self.model), cfg.chunk)
        self.runner = lambda rays: renderer(
            None, {k: rays[k] for k in cli.RAY_KEYS})

    def free(self) -> None:
        self.runner = self.model = None


def make_items(mix: Dict, seed: int, device, cfg) -> Dict:
    """The mix's whole views (scenes.make_items' "image" kind), their rays
    alone."""
    if mix["kind"] != "image":
        raise ValueError(f"mix {mix['name']} is {mix['kind']!r}; the "
                         f"vanilla adapter renders 'image' items")
    pool = scenes.make_items(mix, seed, device, 0)
    items = [{k: it[k] for k in scenes.RAY_KEYS} for it in pool["items"]]
    return dict(pool, items=items)


# ----------------------------------------------------------- the reference

def reference_train(config, weights, trainer, items, gen_seed, device,
                    kind="f32", fault=None):
    raise NotImplementedError("no vanilla cell trains")


def reference_render(config: Dict, weights, setup, rays: Dict,
                     kind: str = "f32", fault=None
                     ) -> Dict[str, torch.Tensor]:
    """The reference's fine-level rgb, depth and acc of `rays`."""
    return ref.render_blocks(weights, ref.Arch.from_config(config), rays,
                             REF_CHUNK, kind, fault)


# ---------------------------------------------------------------- the work

@dataclass
class Work:
    """One view: `rays` rays of one scene through each level's `samples`
    points; the MLP's sizes."""
    rays: int
    samples: Tuple[int, int]
    netdepth: int
    netwidth: int
    skip_layer: int
    netdepth_condition: int
    netwidth_condition: int
    point_features: int
    view_features: int
    scenes: int = 1


def work(config: Dict, mix: Dict, cfg) -> Work:
    w, h = mix["img_wh"]
    coarse = config["num_coarse_samples"] + 1
    degs = config["max_deg_point"] - config["min_deg_point"]
    return Work(rays=w * h,
                samples=(coarse, coarse + config["num_fine_samples"]),
                netdepth=config["netdepth"], netwidth=config["netwidth"],
                skip_layer=config["skip_layer"],
                netdepth_condition=config["netdepth_condition"],
                netwidth_condition=config["netwidth_condition"],
                point_features=3 * (1 + 2 * degs),
                view_features=3 * (1 + 2 * config["deg_view"]))


def mlp_macs(w: Work) -> int:
    """Multiply-adds of one level's MLP at one sample: the trunk with its
    skip inputs, the density head, the bottleneck, the view branch and the
    rgb head."""
    width_in, macs = w.point_features, 0
    for i in range(w.netdepth):
        macs += width_in * w.netwidth
        skip = i % w.skip_layer == 0 and i > 0
        width_in = w.netwidth + (w.point_features if skip else 0)
    macs += width_in * (1 + w.netwidth)
    width_in = w.netwidth + w.view_features
    for _ in range(w.netdepth_condition):
        macs += width_in * w.netwidth_condition
        width_in = w.netwidth_condition
    return macs + width_in * 3


def item_flops(w: Work) -> float:
    """Both levels' MLP at every sample of the view, two per
    multiply-add."""
    return 2.0 * mlp_macs(w) * w.scenes * w.rays * sum(w.samples)


# -------------------------------------------------------------- CPU tests

def tiny_sizes(config: Dict) -> Dict:
    """The configuration keys the CPU tests replace."""
    return dict(TINY)


@contextlib.contextmanager
def tiny(config: Dict):
    """The port's vanilla MLPs at TINY_WIDTHS while the block runs; yields
    `tiny_sizes(config)`."""
    from neo360_tpu_torch.models import vanilla
    saved = vanilla.NeRFMLP

    class Tiny(saved):
        __init__ = functools.partialmethod(saved.__init__, **TINY_WIDTHS)

    vanilla.NeRFMLP = Tiny
    try:
        yield tiny_sizes(config)
    finally:
        vanilla.NeRFMLP = saved
