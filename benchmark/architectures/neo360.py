"""NeO-360 (arXiv:2308.12967) and the port's neo360_fast preset behind the
adapter interface of the shared harness (registry.py lists the interface
and the rules). What the harness knows of NeO-360 lives here:

- `Program`: the system under test, built through the port's CLI;
- `make_items`: the few-shot mixes of scenes.py at the program's K, S and
  B;
- `reference_train`, `reference_render`: the plain reference
  (benchmark/reference/) on the same weights and inputs;
- `Work`, `of`, `work`: the work of one item, which the roofline families
  in `FAMILIES` count bytes of; `item_flops`: its model FLOPs;
- `FAULTS`: the faults the reference can plant for the control;
- `tiny_sizes`, `tiny`: the sizes of the CPU tests.

`Program` builds the configuration's model through the port's CLI
(`cli.build_model` on the preset the configuration names, with the
configuration's sizes), loads the benchmark's seeded weights into it by
its `state_dict` names, and drives one item of a traffic mix at a time
through the port's own entries:
- "stage": `loop.make_scene_stage_trainer` on `make_scene_stage_fns`,
  each partition's optimizer from `cli.build_optimizer`;
- "step": `loop.make_staged_trainer(loop.make_train_step(
  cli.make_loss_fn(...)))`, one step a call;
- "view": `model.encode` once in set-up, then `loop.make_image_renderer`
  over the view in the preset's tiles (rgb and depth).
The trainer's knobs (K, S, the tile, the recompute, the cotangent dtype,
BatchNorm's eval mode) are the preset's as the CLI builds them. The port
is imported inside the functions that drive it, never when this module
is loaded.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

from benchmark import check, scenes
from benchmark.reference import model as ref
from benchmark.reference import train as ref_train

# the roofline families (rooflines/<name>.py) of NeO-360's kernels
FAMILIES = ("composite_transpose", "gather_transpose", "lift_gather",
            "local_gather", "nerfpp_composite", "pillar_collapse",
            "pillar_transpose", "triplane_gather")
# the faults the reference plants in the program's place (control.py)
FAULTS = ("half", "rgb", "band")
# configuration keys that are fields of the port's Config
SIZE_KEYS = ("grid_size", "num_coarse_samples", "num_prop_samples",
             "num_fine_samples", "encoder_width", "lift_dim", "plane_dim",
             "local_proj_dim", "pillar_width", "depth_fc_layers",
             "ray_batch_size", "num_src_views")
REF_CHUNK = 1024
# the CPU tests' sizes (float32: the CPU's bf16 convolutions are not
# deterministic at some shapes)
TINY = {"grid_size": [8, 8, 4], "encoder_width": 64, "pillar_width": 64,
        "num_prop_samples": 8, "num_coarse_samples": 8,
        "num_fine_samples": 6, "ray_batch_size": 16, "plane_hw": [30, 40],
        "precision": "float32", "img_wh": [40, 30]}


def kernel_library() -> None:
    """Build (first run in a checkout) or load the port's kernels."""
    from neo360_tpu_torch.ops import kernels
    kernels.build()
    kernels.library()


def trainer_kind(cfg) -> str:
    return "scene_stage" if cfg.stage_k > 1 else "per_step"


# ------------------------------------------------------------- the program

class Program:
    def __init__(self, config: Dict, seed: int, device: torch.device,
                 generator_seed: int):
        from neo360_tpu_torch import cli
        from neo360_tpu_torch.config import preset
        from neo360_tpu_torch.nn.triplane import GridEncoder
        self.cli = cli
        sizes = {k: config[k] for k in SIZE_KEYS if k in config}
        if sizes.get("grid_size") is not None:
            sizes["grid_size"] = tuple(sizes["grid_size"])
        cfg = preset(config["exp_type"], seed=seed % 2 ** 31,
                     device=str(device), **sizes)
        cfg = cfg.replace(bf16=config["precision"] == "bfloat16")
        if tuple(GridEncoder.plane_hw) != tuple(config["plane_hw"]):
            raise ValueError(f"the program's tri-planes are "
                             f"{GridEncoder.plane_hw}, the configuration's "
                             f"{config['plane_hw']}")
        self.cfg = cfg
        self.device = device
        cli.float32_matmuls(cfg, device)
        self.model = cli.build_model(cfg, device)
        self.generator = torch.Generator(device).manual_seed(generator_seed)
        self.runner = self.state = None
        self.recorded: List[torch.Tensor] = []
        self.recording = False

    # ---------------------------------------------------------------- set-up
    def shapes(self) -> Dict[str, tuple]:
        return {k: tuple(v.shape) for k, v in self.model.state_dict().items()}

    def trained_names(self) -> List[str]:
        return [k for k, p in self.model.named_parameters()
                if p.requires_grad]

    def load(self, weights: Dict[str, torch.Tensor]) -> None:
        self.model.load_state_dict(weights, strict=True)

    def trainer_kind(self) -> str:
        return trainer_kind(self.cfg)

    def make_trainer(self) -> None:
        from neo360_tpu_torch.models.neo360 import make_scene_stage_fns
        from neo360_tpu_torch.train import loop
        cfg, cli, model = self.cfg, self.cli, self.model
        model.train()
        make_opt = lambda params: cli.build_optimizer(cfg, params)
        if self.trainer_kind() == "scene_stage":
            encode_fn, loss_fn = make_scene_stage_fns(
                model, cfg.white_back, mixed=cfg.stage_scenes > 1)

            def recording_loss(*args, **kw):
                loss, metrics = loss_fn(*args, **kw)
                if self.recording:
                    self.recorded.append(loss.detach())
                return loss, metrics

            self.state = loop.create_scene_stage_state(model, make_opt)
            stage = loop.make_scene_stage_trainer(
                encode_fn, recording_loss,
                cot_dtype=getattr(torch, cfg.stage_cot_dtype))
            keys = cli.SRC_KEYS

            def run(item):
                src = {k: item[k] for k in keys}
                rays = {k: item[k] for k in cli.STAGE_RAY_KEYS}
                return stage(self.state, src, rays, self.generator)
        else:
            self.state = loop.create_train_state(model, make_opt)
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
        """Each trained leaf's Adam first moment, by name."""
        st = self.state
        pairs = []
        if hasattr(st, "opt"):
            pairs.append((st.params, st.opt))
        else:
            pairs += [(st.enc_params, st.enc_opt), (st.ray_params,
                                                    st.ray_opt)]
        return {n: m for params, opt in pairs
                for n, m in zip(params, opt.mu)}

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach() for k, p in self.model.named_parameters()}

    def make_renderer(self, src: Dict[str, torch.Tensor]) -> None:
        """Encode the scene (set-up) and bind the tile renderer."""
        from neo360_tpu_torch.models.neo360 import SRC_KEYS
        from neo360_tpu_torch.train import loop
        cfg, model = self.cfg, self.model
        model.eval()
        batch_stats = cfg.eval_bn_mode == "batch"
        with torch.inference_mode():
            enc = model.encode(*(src[k] for k in SRC_KEYS), batch_stats)

        def render_chunk(pack, chunk):
            out = model(dict(chunk, **src), pack, cfg.white_back,
                        out_depth=True)[1]
            return {"rgb": out["rgb"], "depth": out["depth"]}

        renderer = loop.make_image_renderer(render_chunk, cfg.chunk)
        self.runner = lambda rays: renderer(enc, rays)

    def free(self) -> None:
        self.runner = self.state = self.model = None
        self.recorded = []


def make_items(mix: Dict, seed: int, device, cfg) -> Dict:
    """The mix's items (scenes.make_items) at the program's K, S and B; a
    training mix has to feed the trainer the preset runs."""
    kind = mix["kind"]
    want = {"stage": "scene_stage", "step": "per_step"}.get(kind)
    if want is not None and want != trainer_kind(cfg):
        raise ValueError(f"mix {mix['name']} feeds a {want} trainer; "
                         f"{cfg.exp_type} trains with {trainer_kind(cfg)}")
    return scenes.make_items(mix, seed, device, cfg.num_src_views,
                             steps=cfg.stage_k if kind == "stage" else 1,
                             scenes_per_item=cfg.stage_scenes,
                             rays_per_step=cfg.ray_batch_size)


# ----------------------------------------------------------- the reference

def reference_train(config: Dict, weights: Dict[str, torch.Tensor],
                    trainer: str, items: List[Dict], gen_seed: int, device,
                    kind: str = "f32", fault=None) -> Dict:
    """The reference follows the program's first len(items) items from
    the same weights and generator seed: {"losses", "moments" (norms after
    the first item), "change" (norms of the change after the last)}."""
    tr = ref_train.Trainer(ref.Arch.from_config(config), weights, trainer,
                           prec=ref.Precision(kind, fault))
    start = {k: v.detach().clone() for k, v in tr.params().items()}
    gen = torch.Generator(device).manual_seed(gen_seed)
    losses, moments = [], None
    with ref.matmul_precision(tr.prec):
        for i, item in enumerate(items):
            losses += tr.step({k: v.to(device) for k, v in item.items()},
                              gen)
            if i == 0:
                moments = check.norms(tr.moments())
    change = check.norms({k: v - start[k] for k, v in tr.params().items()})
    return {"losses": losses, "moments": moments, "change": change}


def reference_render(config: Dict, weights, src: Dict, rays: Dict,
                     kind: str = "f32", fault=None
                     ) -> Dict[str, torch.Tensor]:
    """The reference's rgb and depth of `rays`, the scene encoded again
    from its source views, deterministic sampling."""
    arch = ref.Arch.from_config(config)
    p = ref.Precision(kind, fault)
    with torch.no_grad(), ref.matmul_precision(p):
        enc = [ref.encode(weights, p, arch, src)]
        n = rays["rays_o"].shape[0]
        outs = [ref.render_rays(weights, p, arch, enc, src,
                                {k: v[i:i + REF_CHUNK]
                                 for k, v in rays.items()})[-1]
                for i in range(0, n, REF_CHUNK)]
    return {k: torch.cat([o[k] for o in outs]) for k in ("rgb", "depth")}


# ---------------------------------------------------------------- the work
# The work of one item (a stage, a step or a view) at a cell's shapes, from
# the configuration file and the traffic: what the FLOP counter and the
# roofline families count. It says nothing of how the program launches it.
#
# `Work` fields:
# - `encodes`: source stacks encoded (a stage: S; a step: 1; a view: 0,
#   the scene is encoded in set-up);
# - `batches`: ray batches rendered, each a list of levels (rays, fg
#   samples, bg samples, conditioned), with the number of such batches;
# - `train`: gradients are taken; `dense_tables`: the tri-plane and local
#   maps' gradients are whole maps every step (the per-step trainer) rather
#   than added up over the stage;
# - the sizes: NV, image, latent map, grid, widths and dtype widths.

@dataclass
class Work:
    nv: int
    image_hw: Tuple[int, int]
    latent_hw: Tuple[int, int]
    grid: Tuple[int, int, int]
    plane_hw: Tuple[int, int]
    encoder_width: int
    lift_width: int
    lift_proj: bool
    plane_dim: int
    local_dim: int
    local_maps: int
    pillar_width: int
    depth_fc_layers: int
    elt: int                    # bytes of the compute dtype
    encodes: int
    batches: List[Tuple[int, List[Tuple[int, int, int, bool]]]] = field(
        default_factory=list)
    train: bool = False
    dense_tables: bool = False

    def conditioned(self):
        """(count, rays, fg samples, bg samples) of every conditioned
        level of the item."""
        return [(count, r, sf, sb) for count, lvls in self.batches
                for r, sf, sb, cond in lvls if cond]

    def all_levels(self):
        return [(count, r, sf, sb) for count, lvls in self.batches
                for r, sf, sb, _ in lvls]


def levels(cfg: Dict, rays: int) -> List[Tuple[int, int, int, bool]]:
    """(rays, fg samples, bg samples, conditioned) of each level."""
    if cfg["use_proposal"]:
        n0 = cfg["num_prop_samples"] + 1
        n1 = cfg["num_fine_samples"] + 1
        return [(rays, n0, n0, False), (rays, n1, n1, True)]
    n0 = cfg["num_coarse_samples"] + 1
    n1 = n0 + cfg["num_fine_samples"]
    return [(rays, n0, n0, True), (rays, n1, n1, True)]


def of(cfg: Dict, kind: str, wh, k: int, s: int, b: int, chunk: int
       ) -> Work:
    """The work of one item of traffic `kind` ("stage", "step", "view")
    at image size wh = (W, H), K steps over S scenes of B rays, tiles of
    `chunk` rays."""
    w, h = wh
    lat = (h // 2, w // 2)
    elt = 2 if cfg["precision"] == "bfloat16" else 4
    base = dict(nv=cfg["num_src_views"], image_hw=(h, w), latent_hw=lat,
                grid=tuple(cfg["grid_size"]), plane_hw=tuple(
                    cfg["plane_hw"]), encoder_width=cfg["encoder_width"],
                lift_width=cfg["lift_dim"] or cfg["encoder_channels"],
                lift_proj=cfg["lift_dim"] is not None,
                plane_dim=cfg["plane_dim"], local_dim=cfg["local_proj_dim"],
                local_maps=1 if cfg["use_proposal"] else 2,
                pillar_width=cfg["pillar_width"],
                depth_fc_layers=cfg["depth_fc_layers"],
                elt=elt)
    if kind == "stage":
        return Work(encodes=s, batches=[(k * s, levels(cfg, b // s))],
                    train=True, **base)
    if kind == "step":
        return Work(encodes=1, batches=[(1, levels(cfg, b))], train=True,
                    dense_tables=True, **base)
    tiles = math.ceil(w * h / chunk)
    return Work(encodes=0, batches=[(tiles, levels(cfg, chunk))], **base)


def work(config: Dict, mix: Dict, cfg) -> Work:
    """The work of one item of `mix` at the program's K, S, B and tile."""
    return of(config, mix["kind"], mix["img_wh"], cfg.stage_k,
              cfg.stage_scenes, cfg.ray_batch_size, cfg.chunk)


# ------------------------------------------------------------------ FLOPs
# Model FLOPs of one item: the convolutions and dense layers of NeO-360 at
# the item's shapes, two per multiply-add; three times the forward for a
# training item (forward, and the backward's two products); a recompute is
# not counted. Whatever implements a layer, it counts the same.

def _conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _conv(h, w, cin, cout, k, s, p):
    """(MACs, out h, out w) of a k x k convolution."""
    ho, wo = _conv_out(h, k, s, p), _conv_out(w, k, s, p)
    return ho * wo * cout * cin * k * k, ho, wo


def resnet34_macs(h: int, w: int) -> int:
    macs, h, w = _conv(h, w, 3, 64, 7, 2, 3)
    h, w = _conv_out(h, 3, 2, 1), _conv_out(w, 3, 2, 1)
    cin = 64
    for stage, (blocks, width) in enumerate(((3, 64), (4, 128), (6, 256))):
        for b in range(blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            m1, ho, wo = _conv(h, w, cin, width, 3, stride, 1)
            m2, _, _ = _conv(ho, wo, width, width, 3, 1, 1)
            macs += m1 + m2
            if stride != 1 or cin != width:
                macs += _conv(h, w, cin, width, 1, stride, 0)[0]
            h, w, cin = ho, wo, width
    return macs


def floorplan_macs(a: int, b: int, cin: int, plane_hw, plane_dim: int
                   ) -> int:
    m0, a, b = _conv(a, b, cin, 256, 3, 2, 1)
    m1, a, b = _conv(a, b, 256, 128, 3, 2, 1)
    m2, a, b = _conv(a, b, 128, 128, 3, 1, 1)
    m3, _, _ = _conv(2 * a, 2 * b, 128, 128, 3, 1, 1)
    m4, _, _ = _conv(plane_hw[0], plane_hw[1], 128, plane_dim, 3, 1, 1)
    return m0 + m1 + m2 + m3 + m4


def encode_macs(w: Work) -> int:
    nv, (h, wd) = w.nv, w.image_hw
    lh, lw = w.latent_hw
    gx, gy, gz = w.grid
    g = gx * gy * gz
    e, f = w.encoder_width, w.pillar_width
    macs = nv * resnet34_macs(h, wd)
    if w.lift_proj:
        macs += nv * lh * lw * 512 * w.lift_width
    depth = (w.lift_width + 6) * e + (w.depth_fc_layers - 1) * e * e + e * e
    if w.depth_fc_layers == 0:
        depth = (w.lift_width + 6) * e
    macs += nv * g * (depth + e * 3 * f + 3 * f)
    for a, b in ((gy, gz), (gx, gz), (gx, gy)):
        macs += nv * floorplan_macs(a, b, e, w.plane_hw, w.plane_dim)
    macs += w.local_maps * 2 * nv * lh * lw * 512 * w.local_dim
    return macs


def mlp_macs(w: Work, rays: int, samples: int, point_dim: int,
             conditioned: bool) -> int:
    pe = point_dim * 21
    if not conditioned:
        return rays * samples * (pe * 128 + 3 * 128 * 128 + 128)
    d_in = pe + w.local_dim + w.plane_dim
    per_view = (d_in * 128 + 2 * 128 * 128 + (128 + d_in) * 128
                + 128 * 128 + (128 + 27) * 64)
    per_point = 128 + 64 * 64 + 64 * 3
    return w.nv * rays * samples * per_view + rays * samples * per_point


def item_flops(w: Work) -> float:
    macs = w.encodes * encode_macs(w)
    for count, lvls in w.batches:
        for rays, s_fg, s_bg, cond in lvls:
            macs += count * (mlp_macs(w, rays, s_fg, 3, cond)
                             + mlp_macs(w, rays, s_bg, 4, cond))
    return 2.0 * macs * (3 if w.train else 1)


# -------------------------------------------------------------- CPU tests

def tiny_sizes(config: Dict) -> Dict:
    """The configuration keys the CPU tests replace: TINY, and a 32-wide
    lift where the configuration lifts."""
    over = dict(TINY)
    if config.get("lift_dim") is not None:
        over["lift_dim"] = 32
    return over


@contextlib.contextmanager
def tiny(config: Dict):
    """The port's tri-planes at TINY's size while the block runs; yields
    `tiny_sizes(config)`."""
    from neo360_tpu_torch.nn.triplane import GridEncoder
    saved = GridEncoder.plane_hw
    GridEncoder.plane_hw = tuple(TINY["plane_hw"])
    try:
        yield tiny_sizes(config)
    finally:
        GridEncoder.plane_hw = saved
