"""Command-line runner for the port (neo360_tpu/cli.py; the `vanilla`,
`mipnerf360`, `pixelnerf`, `neo360` and `neo360_fast` presets).

Usage:
    python -m neo360_tpu_torch.cli --exp_type neo360 --root_dir <scenes>
    python -m neo360_tpu_torch.cli --exp_type neo360_fast --root_dir <scenes>
    python -m neo360_tpu_torch.cli --exp_type vanilla --root_dir <scene>
    python -m neo360_tpu_torch.cli --exp_type mipnerf360 --root_dir <scene>
    python -m neo360_tpu_torch.cli --exp_type pixelnerf --root_dir <scenes>
    python -m neo360_tpu_torch.cli --exp_type neo360 --root_dir <scenes> \
        --eval_mode full_eval|vis_only \
        [--ckpt_path model.pt|ckpt_*.pt|variables.npz]

`vanilla` is the vanilla NeRF of one scene (64 + 128 samples, 8 x 256
MLP, float32): it trains with the ray-buffer trainer, --batch_size rays a
step drawn on the device from every train ray of the scene, and evaluates
the scene's val/ views. `mipnerf360` is MipNeRF-360 of one scene (two
64-sample proposal levels of 4 x 256, 32 NeRF samples through 8 x 1024,
lifted IPE, float32): the same ray-buffer trainer and eval, with the pixel
radii, the anneal of the step count and the loss sqrt(mse + 1e-6) +
interlevel + 0.01 distortion. `pixelnerf` is PixelNeRF (ResNet34 pixel
latents, 64 + 64 samples, 4 x 128 MLP): it trains with the per-step
trainer like `neo360`, the encoder every step.

`neo360` (alias `triplanar_nocs_fusion_conv_scene`) is the reference
model: a conditioned coarse level, 128 + 256 merged samples, the 64^3 grid
with the 512-channel lift, float32. `neo360_fast` is the proposal model
(bf16, grid (64,64,32), lift 128).

Without --eval_mode it trains. With --stage_k <= 1 (the `neo360` preset)
the per-step trainer encodes the source views every step and takes one
Adam step with one global clip over all parameters; with --stage_k > 1
(the `neo360_fast` preset: K=32 steps per stage, S=2 scenes per step; for
either model) the scene-mixed, encode-once stage trainer runs, after
--stage_warmup_steps per-step steps if asked. Metrics go to
<ckpt_dir>/<exp_name>/metrics.jsonl, checkpoints to
<ckpt_dir>/<exp_name>/checkpoints/, and a run resumes from the newest
one (a checkpoint of the other trainer's layout raises);
--ckpt_path warm-starts the weights (parameters and BatchNorm buffers)
from another run's checkpoint of either layout or a JAX npz, with a fresh
optimizer at step 0; --resnet_weights loads a torchvision resnet34 (or the
npz of scripts/convert_weights.py) into the SpatialEncoder's backbone.
--is_optimize (per-scene optimize) and --finetune_lpips (stage 2, with
--lpips_weights) train with the per-step trainer whatever --stage_k says:
the SpatialEncoder frozen, every BatchNorm on its running statistics, lr
pinned to 5e-6; optimize draws the fixed source views [0, 38, 44] and
caches each scene's frozen pixel latents once, and keeps every
checkpoint; the finetune adds 0.3 x LPIPS on one 30x30 patch per step.
With --eval_mode full_eval it renders every test view of every scene
under root_dir (vanilla, mipnerf360: of the one scene): each scene's
source stack is encoded once, then views are rendered in `--chunk`-ray
tiles; PSNR / SSIM (+ object PSNR) go to
<ckpt_dir>/<exp_name>/results.json and images to .../<render_name>/.
Eval weights come from --ckpt_path (a port state_dict, a training
checkpoint of either layout or a JAX-exported npz, neo360_tpu/utils/io.py:
save_variables_npz, converted by weights.py), else <exp_dir>/model.pt,
else the newest training checkpoint, else a seeded random init (with a
warning); with --lpips_weights each view's LPIPS is reported too.
--eval_mode vis_only does the same, writes the views as a video and
renders a 40-frame 360-degree spiral around the first test pose (the
few-shot models: scene 0's) as video360.mp4 (or .gif). Both
run on --device (default cuda) and raise when it is absent; a float32
model on the card runs with TF32 off.

On a host with more than one visible card, `main` starts one
data-parallel rank per card (`parallel.sharding.launch`; `world_size=`
sets the count, as the tests and chip_smoke.py do); under torchrun each
process joins the group torchrun describes, on cuda:LOCAL_RANK. The ranks
split each step's rays (batch_size and ray_batch_size rounded up to a
multiple of the rank count), average their gradients before the
optimizer, split each view's render tiles, and only rank 0 writes logs,
checkpoints and eval artifacts (neo360_tpu/cli.py:487-510, the `mesh=`
paths of run_train, _run_warmup and run_eval).
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from neo360_tpu_torch import weights
from neo360_tpu_torch.config import Config, preset
from neo360_tpu_torch.core.spans import span
# the single-scene models' sampling bounds (neo360_tpu/cli.py:215, 230,
# 371)
from neo360_tpu_torch.data.nerds360 import FAR as SCENE_FAR
from neo360_tpu_torch.data.nerds360 import NEAR as SCENE_NEAR
from neo360_tpu_torch.parallel import sharding
from neo360_tpu_torch.train.loop import TrainState

SRC_KEYS = ("src_imgs", "src_poses", "src_focal", "src_c")
RAY_KEYS = ("rays_o", "rays_d", "viewdirs")
MIP_RAY_KEYS = RAY_KEYS + ("radii",)
# MipNeRF-360's anneal runs over this many steps (neo360_tpu/cli.py:224)
MIP_ANNEAL_STEPS = 1.0e6
# the presets of one scene, trained by the ray-buffer trainer
SINGLE_SCENE = ("vanilla", "mipnerf360")
STAGE_RAY_KEYS = ("rays_o", "rays_d", "viewdirs", "target")
# one per-step training batch: a sample_train draw (neo360_tpu/cli.py:
# RAY_KEYS_FEWSHOT + target)
STEP_KEYS = RAY_KEYS + SRC_KEYS + ("target",)
# optimize and finetune: the pinned lr (neo360_tpu/cli.py:153) and the
# weight of the finetune's LPIPS term (neo360_tpu/cli.py:298)
FROZEN_LR = 5.0e-6
LPIPS_WEIGHT = 0.3


def parse_args(argv=None) -> Config:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp_type", required=True)
    p.add_argument("--root_dir", required=True)
    p.add_argument("--exp_name", default="exp")
    p.add_argument("--img_wh", nargs=2, type=int, default=[320, 240])
    p.add_argument("--white_back", action="store_true")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--ray_batch_size", type=int, default=500)
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--num_src_views", type=int, default=None)
    p.add_argument("--run_max_steps", type=int, default=100000)
    p.add_argument("--lr_init", type=float, default=None)
    p.add_argument("--eval_mode", choices=["full_eval", "vis_only"],
                   default=None)
    p.add_argument("--render_name", default="3views")
    p.add_argument("--is_optimize", action="store_true")
    p.add_argument("--finetune_lpips", action="store_true")
    p.add_argument("--ckpt_dir", default="ckpts")
    p.add_argument("--ckpt_path", default=None)
    p.add_argument("--lpips_weights", default=None)
    p.add_argument("--resnet_weights", default=None)
    p.add_argument("--val_every_steps", type=int, default=5000)
    p.add_argument("--save_every_steps", type=int, default=5000)
    p.add_argument("--seed", type=int, default=0)
    # absent: the preset's bf16 (the JAX CLI's False default overrides it)
    p.add_argument("--bf16", action="store_true", default=None,
                   help="bf16 compute in encoders/MLPs (params stay f32)")
    p.add_argument("--stage_k", type=int, default=None)
    p.add_argument("--stage_scenes", type=int, default=None)
    p.add_argument("--stage_warmup_steps", type=int, default=None)
    p.add_argument("--eval_bn_mode", choices=["batch", "running"],
                   default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises if absent)")
    a = p.parse_args(argv)
    # the source-view count rides the render_name's leading digit
    if a.num_src_views is None and a.render_name[:1].isdigit():
        a.num_src_views = int(a.render_name[0])
    overrides = {k: v for k, v in vars(a).items()
                 if v is not None and k not in ("exp_type", "img_wh")}
    return preset(a.exp_type, img_wh=tuple(a.img_wh), **overrides)


def frozen_encoder(cfg: Config) -> bool:
    """The optimize and finetune modes freeze the SpatialEncoder and run
    every BatchNorm on its running statistics."""
    return cfg.is_optimize or cfg.finetune_lpips


def build_optimizer(cfg: Config, params):
    """Adam clipped to cfg.grad_max_norm over `params` alone, so each
    partition clips to its own norm (neo360_tpu/cli.py:139-174): on the
    warm-up-sine x log-lerp schedule in normal training; at the pinned
    FROZEN_LR in the optimize and finetune modes, whose `params` are the
    trained partition only (`freeze_spatial_encoder`), as the JAX CLI's
    `optax.multi_transform` splits the gradients before its clip."""
    from neo360_tpu_torch.train.optim import Adam
    from neo360_tpu_torch.train.schedules import nerf_schedule
    if frozen_encoder(cfg):
        return Adam(params, FROZEN_LR, max_norm=cfg.grad_max_norm)
    sched = nerf_schedule(cfg.lr_init, cfg.lr_final, cfg.run_max_steps,
                          cfg.lr_delay_steps, cfg.lr_delay_mult)
    return Adam(params, sched, max_norm=cfg.grad_max_norm)


def freeze_spatial_encoder(model) -> None:
    """The frozen partition of the optimize and finetune modes: the
    SpatialEncoder's parameters take no gradient, so the per-step trainer
    leaves them out of its optimizer and its clip norm (the JAX CLI's
    `set_to_zero` partition, which labels the `spatial_encoder` subtree:
    PixelNeRF's encoder is named `encoder`, so nothing of it is frozen)."""
    spatial = getattr(model.encoder, "spatial_encoder", None)
    if spatial is not None:
        spatial.requires_grad_(False)


def resolve_device(cfg: Config, device=None) -> torch.device:
    """`device` or cfg.device; raise if it is a CUDA device and there is
    none (no silent fall back to the CPU). In a data-parallel group a
    device of the group's type is the rank's own (cuda:LOCAL_RANK)."""
    dev = torch.device(device or cfg.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available; pass --device cpu to run on the CPU")
    group = sharding.current()
    if group is not None and group.device.type == dev.type:
        return group.device
    return dev


def float32_matmuls(cfg: Config, device: torch.device) -> None:
    """For a float32 config on a CUDA device, turn TF32 off for matmuls
    and convolutions (process-wide), so they round as the CPU computes
    them, and say so. run_train and run_eval call it once."""
    if device.type == "cuda" and not cfg.bf16:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"{cfg.exp_type}: float32 on {device}, TF32 off for matmuls "
              f"and convolutions")


def build_model(cfg: Config, device=None):
    """The preset's model on `device` (default cfg.device, see
    `resolve_device`), initialised from cfg.seed.

    vanilla: VanillaNeRF, cfg.num_coarse_samples or 64 coarse and
    cfg.num_fine_samples or 128 fine samples, float32. mipnerf360:
    MipNeRF360 at the JAX model's widths (8 x 1024 NeRF MLP, two 4 x 256
    proposal MLPs), cfg.num_prop_samples or 64 proposal and
    cfg.num_fine_samples or 32 NeRF samples. pixelnerf:
    PixelNeRF over cfg.num_src_views views, 64 + 64 samples unless
    overridden, bf16 compute with cfg.bf16.

    neo360 (neo360_tpu/cli.py:117-124): the conditioned coarse level,
    cfg.num_coarse_samples or 128 coarse and cfg.num_fine_samples or 256
    fine samples, grid cfg.grid_size or (64, 64, 64), the encoder's grid
    part recomputed in the backward unless cfg.remat_encoder is False.
    neo360_fast: the proposal level, 64 proposal and cfg.num_fine_samples
    or 64 fine samples, grid (64, 64, 32), no recompute unless
    cfg.remat_encoder is True. Both take cfg.encoder_width, plane_dim,
    local_proj_dim, pillar_width and depth_fc_layers where set. Compute
    is bf16 with cfg.bf16, else float32 (see `float32_matmuls` for
    TF32)."""
    device = resolve_device(cfg, device)
    generator = torch.Generator().manual_seed(cfg.seed)
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    if cfg.exp_type == "vanilla":
        from neo360_tpu_torch.models.vanilla import VanillaNeRF
        model = VanillaNeRF(
            num_coarse_samples=cfg.num_coarse_samples or 64,
            num_fine_samples=cfg.num_fine_samples or 128,
            generator=generator)
        return model.to(device).eval()
    if cfg.exp_type == "mipnerf360":
        from neo360_tpu_torch.models.mipnerf360 import MipNeRF360
        model = MipNeRF360(num_prop_samples=cfg.num_prop_samples or 64,
                           num_nerf_samples=cfg.num_fine_samples or 32,
                           dtype=dtype, generator=generator)
        return model.to(device).eval()
    if cfg.exp_type == "pixelnerf":
        from neo360_tpu_torch.models.pixelnerf import PixelNeRF
        model = PixelNeRF(
            num_src_views=cfg.num_src_views, compute_dtype=dtype,
            num_coarse_samples=cfg.num_coarse_samples or 64,
            num_fine_samples=cfg.num_fine_samples or 64,
            generator=generator)
        return model.to(device).eval()
    from neo360_tpu_torch.models.neo360 import NeRFTP
    size = {k: getattr(cfg, k) for k in (
        "encoder_width", "plane_dim", "local_proj_dim", "pillar_width",
        "depth_fc_layers") if getattr(cfg, k) is not None}
    if cfg.exp_type == "neo360":
        size.update(use_proposal=False,
                    num_coarse_samples=cfg.num_coarse_samples or 128,
                    num_fine_samples=cfg.num_fine_samples or 256,
                    grid_size=tuple(cfg.grid_size or (64, 64, 64)),
                    remat_encoder=cfg.remat_encoder is not False)
    else:
        size.update(use_proposal=True,
                    num_prop_samples=cfg.num_prop_samples or 64,
                    num_fine_samples=cfg.num_fine_samples or 64,
                    grid_size=tuple(cfg.grid_size or (64, 64, 32)),
                    remat_encoder=cfg.remat_encoder is True)
    model = NeRFTP(num_src_views=cfg.num_src_views, compute_dtype=dtype,
                   lift_dim=cfg.lift_dim, generator=generator, **size)
    return model.to(device).eval()


def make_render_fn(cfg: Config, model, device=None):
    """render_fn(sample) -> the fine level's outputs over a full image of
    rays, with the sample's arrays placed on `device` (default cfg.device,
    see `resolve_device`): {"rgb", "depth", "acc"} for vanilla and
    mipnerf360 (its NeRF level, train_frac 1, no jitter), {"rgb",
    "depth"} for pixelnerf, {"rgb", "depth", "fg_rgb", "bg_rgb", "fg_acc",
    "bg_acc"} for the NeO-360 models.

    A few-shot model encodes the source stack once per scene: samples
    carrying the same "scene_key" reuse the previous encode (one scene
    resident at a time); a sample without one is encoded anew."""
    from neo360_tpu_torch.train.loop import make_image_renderer
    device = resolve_device(cfg, device)
    group = sharding.current()
    batch_stats = cfg.eval_bn_mode == "batch"
    place = lambda sample, keys: {
        k: torch.as_tensor(np.asarray(sample[k]), device=device)
        for k in keys}

    if cfg.exp_type == "vanilla":
        def render_chunk(_, rays):
            out = model(rays, cfg.white_back, SCENE_NEAR, SCENE_FAR)[1]
            return {k: out[k] for k in ("rgb", "depth", "acc")}

        renderer = make_image_renderer(render_chunk, cfg.chunk, group)
        return lambda sample: renderer(None, place(sample, RAY_KEYS))

    if cfg.exp_type == "mipnerf360":
        def render_chunk(_, rays):
            out = model(rays, 1.0, False, SCENE_NEAR, SCENE_FAR)[0][-1]
            return {k: out[k] for k in ("rgb", "depth", "acc")}

        renderer = make_image_renderer(render_chunk, cfg.chunk, group)
        return lambda sample: renderer(None, place(sample, MIP_RAY_KEYS))

    if cfg.exp_type == "pixelnerf":
        def render_chunk(pack, rays):
            out = model(dict(rays, **pack["src"]), pack["enc"],
                        cfg.white_back)[1]
            return {"rgb": out["rgb"], "depth": out["depth"]}

        def encode(src):
            return model.encode(src["src_imgs"], batch_stats)
    else:
        def render_chunk(pack, rays):
            out = model(dict(rays, **pack["src"]), pack["enc"],
                        cfg.white_back, out_depth=True)[1]
            return {k: out[k] for k in ("rgb", "depth", "fg_rgb", "bg_rgb",
                                        "fg_acc", "bg_acc")}

        def encode(src):
            return model.encode(src["src_imgs"], src["src_poses"],
                                src["src_focal"], src["src_c"], batch_stats)

    renderer = make_image_renderer(render_chunk, cfg.chunk, group)
    cache: Dict = {}

    @torch.inference_mode()
    def get_pack(sample):
        key = sample.get("scene_key")
        if key is not None and key in cache:
            return cache[key]
        src = place(sample, SRC_KEYS)
        pack = {"src": src, "enc": encode(src)}
        cache.clear()
        if key is not None:
            cache[key] = pack
        return pack

    return lambda sample: renderer(get_pack(sample), place(sample, RAY_KEYS))


def load_weights(model, path: str) -> None:
    """Load `path` into `model`: a `.npz` is a JAX export
    (weights.from_flax_flat), a training checkpoint of either trainer gives
    its parameters and BatchNorm buffers, anything else is a port
    state_dict. Raises on any key that does not fit."""
    if path.endswith(".npz"):
        sd = weights.from_flax_flat(weights.load_variables_npz(path))
    else:
        sd = weights.from_checkpoint(
            torch.load(path, map_location="cpu", weights_only=True))
    weights.load_into(model, sd)


def restore(cfg: Config, model, exp_dir: str) -> Optional[str]:
    """Load weights into `model` (`load_weights`) from cfg.ckpt_path, else
    <exp_dir>/model.pt, else the newest training checkpoint in
    <exp_dir>/checkpoints. Returns the path loaded, or None (random
    init)."""
    from neo360_tpu_torch.train.checkpoints import CheckpointManager
    path = cfg.ckpt_path or os.path.join(exp_dir, "model.pt")
    if not os.path.exists(path):
        if cfg.ckpt_path:
            raise FileNotFoundError(f"--ckpt_path {path}: no such file")
        mgr = CheckpointManager(os.path.join(exp_dir, "checkpoints"))
        if mgr.latest_step() is None:
            return None
        path = mgr.path(mgr.latest_step())
    load_weights(model, path)
    return path


def run_eval(cfg: Config, device=None, n_frames: int = 40, dataset=None
             ) -> Dict[str, float]:
    """Evaluate (neo360_tpu/cli.py:run_eval, 860-950): every test view of
    the root (vanilla, mipnerf360: the scene's val/ views; the few-shot
    models: every scene's, each scene's source stack encoded once),
    metrics to results.json and images under <exp_dir>/<render_name>. With
    --eval_mode vis_only the views also become a video and an
    `n_frames`-frame spiral becomes video360 (`_render_trajectory`).
    `dataset`: the test split to use instead of cfg.root_dir's. In a
    data-parallel group every rank renders its tiles of every view and
    only rank 0 writes. Returns the summary."""
    from neo360_tpu_torch.nn.lpips import LPIPSModel
    from neo360_tpu_torch.train.eval import evaluate_and_save
    from neo360_tpu_torch.train.pipeline import prefetch_to_device

    if cfg.lpips_weights and not os.path.exists(cfg.lpips_weights):
        raise FileNotFoundError(f"--lpips_weights {cfg.lpips_weights}: no "
                                f"such file")
    device = resolve_device(cfg, device)
    float32_matmuls(cfg, device)
    lpips_model = (LPIPSModel(cfg.lpips_weights).to(device)
                   if cfg.lpips_weights else None)
    model = build_model(cfg, device)
    exp_dir = os.path.join(cfg.ckpt_dir, cfg.exp_name)
    loaded = restore(cfg, model, exp_dir)
    if loaded is None:
        print("WARNING: no checkpoint found; evaluating random init")
    else:
        print(f"loaded weights from {loaded}")

    render_fn = make_render_fn(cfg, model, device)
    test_ds = dataset
    if cfg.exp_type in SINGLE_SCENE:
        from neo360_tpu_torch.data.nerds360 import NeRDS360
        test_ds = test_ds or NeRDS360(cfg.root_dir, "test", cfg.img_wh)
        samples = (test_ds.image_rays(i) for i in range(test_ds.num_images))
        extra = {}
    else:
        from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE
        print(f"eval encode BN mode: {cfg.eval_bn_mode}")
        test_ds = test_ds or NeRDS360AE(cfg.root_dir, "test", cfg.img_wh,
                                        cfg.num_src_views)
        samples = (dict(test_ds.sample_test(s, d), scene_key=s)
                   for s in range(len(test_ds.scene_ids))
                   for d in range(test_ds.num_test_views(s)))
        extra = {"eval_bn_mode": cfg.eval_bn_mode}
    out_dir = os.path.join(exp_dir, cfg.render_name)
    vis = cfg.eval_mode == "vis_only"
    # each view's rays and target are made on a worker thread while the
    # previous view renders; render_fn places them on the device
    with prefetch_to_device(samples, size=2, device=None) as samples:
        summary = evaluate_and_save(
            render_fn, samples, cfg.img_wh, out_dir,
            results_json=os.path.join(exp_dir, "results.json"),
            extra=extra, lpips_model=lpips_model, video=vis,
            primary=sharding.is_primary_process())
    if vis:
        path = _render_trajectory(cfg, render_fn, test_ds, out_dir, n_frames)
        if path is not None:
            print("wrote 360 flythrough:", path)
    print("eval summary:", summary)
    return summary


def _render_trajectory(cfg: Config, render_fn, test_ds, out_dir: str,
                       n_frames: int = 40) -> str:
    """vis_only: render `n_frames` poses of a 360-degree spiral
    (train.eval.trajectory_360) around the first test pose (vanilla and
    mipnerf360: `test_ds.c2w[0]`; the few-shot models: scene 0's first
    test pose, else its first train pose, with its test source stack, so
    its cached encode serves every frame) and store them as video360.mp4
    (or .gif); returns the path (neo360_tpu/cli.py:952-974), or None on a
    data-parallel rank other than 0, which renders its tiles and writes
    nothing."""
    from neo360_tpu_torch.train.eval import trajectory_360
    from neo360_tpu_torch.utils import io
    w, h = cfg.img_wh
    if cfg.exp_type in SINGLE_SCENE:
        samples = (test_ds.pose_rays(p)
                   for p in trajectory_360(np.asarray(test_ds.c2w[0]),
                                           n_frames))
    else:
        meta = test_ds.scene_meta(test_ds.scene_ids[0])
        base = (meta.c2w_test[0] if len(meta.c2w_test)
                else meta.c2w_train[0])
        samples = (dict(test_ds.sample_pose(0, p), scene_key=0)
                   for p in trajectory_360(base, n_frames))
    frames = [_host(render_fn(s)["rgb"]).reshape(h, w, 3) for s in samples]
    if not sharding.is_primary_process():
        return None
    return io.store_video(out_dir, frames, name="video360.mp4")


def _host(x) -> np.ndarray:
    """A rendered tensor (or array) as a float32 host array."""
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _check_train_mode(cfg: Config) -> None:
    """Raise on a training configuration the trainers cannot run: the
    stage trainer's ray batch must split evenly over its scenes."""
    if cfg.stage_k > 1 and not frozen_encoder(cfg) and \
            cfg.ray_batch_size % cfg.stage_scenes:
        raise ValueError(f"ray_batch_size {cfg.ray_batch_size} must divide "
                         f"by stage_scenes {cfg.stage_scenes}")


def _cpu(tensors: Dict) -> Dict:
    return {k: v.detach().cpu() for k, v in tensors.items()}


def checkpoint_payload(state) -> Dict:
    """The checkpoint of either trainer's state, on the CPU: the step, the
    BatchNorm buffers (every buffer a state_dict holds) and, for a TrainState (the per-step trainer), all
    parameters (the frozen ones too) and the one Adam state of the trained
    ones; for a SceneStageState both parameter partitions and both Adam
    states."""
    held = state.model.state_dict()   # no non-persistent buffer
    out = {"step": state.step,
           "batch_stats": _cpu({k: v for k, v in
                                state.model.named_buffers() if k in held})}
    if isinstance(state, TrainState):
        out.update(params=_cpu(dict(state.model.named_parameters())),
                   opt=state.opt.state_dict())
    else:
        out.update(enc_params=_cpu(state.enc_params),
                   ray_params=_cpu(state.ray_params),
                   enc_opt=state.enc_opt.state_dict(),
                   ray_opt=state.ray_opt.state_dict())
    return out


def resume(ckpt, state) -> int:
    """Load the newest checkpoint of `ckpt` into `state`; returns its step
    (0 without one). A checkpoint written by the other trainer raises, as
    the JAX CLI's restore does (neo360_tpu/cli.py:529-550)."""
    raw = ckpt.restore()
    if raw is None:
        return 0
    keys = ("params", "opt") if isinstance(state, TrainState) else (
        "enc_params", "ray_params", "enc_opt", "ray_opt")
    missing = [k for k in keys if k not in raw]
    if missing:
        raise ValueError(
            f"failed to restore checkpoint at step {raw['step']}: "
            f"KeyError: {missing}\n"
            f"If the error is a tree-structure mismatch, the likely cause "
            f"is a trainer-layout change — resuming a per-step run with "
            f"--stage_k (or vice versa) is not supported; start a fresh "
            f"exp_name or keep the original trainer flags.")
    weights.load_into(state.model, weights.from_checkpoint(raw))
    if isinstance(state, TrainState):
        state.opt.load_state_dict(raw["opt"])
    else:
        state.enc_opt.load_state_dict(raw["enc_opt"])
        state.ray_opt.load_state_dict(raw["ray_opt"])
    state.step = int(raw["step"])
    print(f"resumed from checkpoint step {state.step}")
    return state.step


def make_loss_fn(cfg: Config, model, randomized: bool = True,
                 lpips_model=None, group=None):
    """loss_fn(batch, generator) -> (loss, {"mse", "psnr", "loss"}) of the
    per-step trainer (neo360_tpu/cli.py:257-301): the batch's source views
    are encoded with BatchNorm in training mode (in the optimize and
    finetune modes on its running statistics, the model in eval mode), its
    rays rendered with randomized sampling drawn from `generator`
    (deterministic sampling if not `randomized`), and the loss is the
    model's: l0 + l1 + distortion for neo360, l1 + interlevel + distortion
    for neo360_fast. A batch with "pixel_latents" (the optimize mode's
    cache, one row per scene) encodes from row "scene_idx" instead of
    running the SpatialEncoder. With --finetune_lpips and a pretrained
    `lpips_model`, LPIPS_WEIGHT x LPIPS of the fine rgb against the target
    is added; the batch must then be a square patch (raises otherwise).

    mipnerf360 (neo360_tpu/cli.py:221-238): loss_fn(batch, generator,
    step), sqrt(mse + 1e-6) + interlevel + 0.01 distortion on the NeRF
    level's MSE, the proposal logits annealed by train_frac = clip(step /
    1e6, 0, 1) of the step count before the step; the interlevel and
    distortion terms are the span `model.regularizers`.

    `group`: the data-parallel ranks that split the batch's rows. The
    terms that are not means over rays see the whole batch: MipNeRF-360's
    MSE under the sqrt is averaged over the ranks, and the finetune's
    LPIPS patch is gathered from them (`sharding.all_reduce_mean`,
    `sharding.all_gather_rows`, both differentiable).

    vanilla and pixelnerf (neo360_tpu/cli.py:210-255): the two levels'
    MSE, l0 + l1; pixelnerf encodes the batch's source views with
    BatchNorm in training mode (on its running statistics in the optimize
    and finetune modes, which for pixelnerf only pin the lr and freeze
    nothing, as the JAX CLI's partition matches no PixelNeRF parameter)."""
    from neo360_tpu_torch.ops.losses import img2mse, mse2psnr
    if cfg.exp_type == "mipnerf360":
        from neo360_tpu_torch.models.mipnerf360 import distortion_loss, \
            interlevel_loss

        def mip_loss(batch, generator, step):
            train_frac = min(max(step / MIP_ANNEAL_STEPS, 0.0), 1.0)
            rays = {k: batch[k] for k in MIP_RAY_KEYS}
            rend, hist = model(rays, train_frac, randomized, SCENE_NEAR,
                               SCENE_FAR, generator=generator)
            mse = img2mse(rend[-1]["rgb"], batch["target"])
            if group is not None:
                mse = sharding.all_reduce_mean(mse, group)
            with span("model.regularizers"):
                interlevel = interlevel_loss(hist)
                distortion = 0.01 * distortion_loss(hist)
            loss = torch.sqrt(mse + 1e-6) + interlevel + distortion
            mse = mse.detach()
            return loss, {"mse": mse, "psnr": mse2psnr(mse),
                          "loss": loss.detach()}

        return mip_loss
    if cfg.exp_type in ("vanilla", "pixelnerf"):
        train_bn = not frozen_encoder(cfg)

        def two_level_loss(batch, generator):
            rays = {k: batch[k] for k in RAY_KEYS}
            if cfg.exp_type == "vanilla":
                out = model(rays, cfg.white_back, SCENE_NEAR, SCENE_FAR,
                            randomized=randomized, generator=generator)
            else:
                rays.update({k: batch[k] for k in SRC_KEYS})
                enc = model.encode(batch["src_imgs"], train_bn)
                out = model(rays, enc, cfg.white_back, randomized=randomized,
                            generator=generator)
            l0 = img2mse(out[0]["rgb"], batch["target"])
            l1 = img2mse(out[1]["rgb"], batch["target"])
            loss = l0 + l1
            l1 = l1.detach()
            return loss, {"mse": l1, "psnr": mse2psnr(l1),
                          "loss": loss.detach()}

        return two_level_loss

    from neo360_tpu_torch.models.neo360 import RAY_KEYS as MODEL_RAY_KEYS
    from neo360_tpu_torch.models.neo360 import SRC_KEYS as MODEL_SRC_KEYS
    from neo360_tpu_torch.models.neo360 import training_loss
    train_bn = not frozen_encoder(cfg)
    use_lpips = (cfg.finetune_lpips and lpips_model is not None
                 and lpips_model.pretrained)
    if use_lpips and group is not None and group.nodes > 1:
        raise ValueError("the LPIPS finetune gathers its patch over the "
                         "ranks of one node; run it on one node")

    def loss_fn(batch, generator):
        latent = None
        if "pixel_latents" in batch:
            latent = batch["pixel_latents"].index_select(
                0, batch["scene_idx"].reshape(1).long())[0]
        enc = model.encode(*(batch[k] for k in MODEL_SRC_KEYS), train_bn,
                           pixel_latent=latent)
        rays = {k: batch[k] for k in MODEL_RAY_KEYS + MODEL_SRC_KEYS}
        out = model(rays, enc, cfg.white_back, randomized=randomized,
                    generator=generator)
        loss, l1 = training_loss(model, out, batch["target"])
        if use_lpips:
            pred, gt = out[1]["rgb"], batch["target"]
            if group is not None:
                pred = sharding.all_gather_rows(pred, group, True)
                gt = sharding.all_gather_rows(gt, group)
            n = gt.shape[0]
            side = math.isqrt(n)
            if side * side != n:
                raise ValueError(f"the LPIPS patch loss needs a square ray "
                                 f"batch (patch_size**2), got {n} rays")
            pred, gt = (torch.clamp(t, 0, 1).reshape(1, side, side, 3)
                        for t in (pred, gt))
            loss = loss + LPIPS_WEIGHT * lpips_model(pred, gt).mean()
        l1 = l1.detach()
        return loss, {"mse": l1, "psnr": mse2psnr(l1),
                      "loss": loss.detach()}

    return loss_fn


def _maybe_load_resnet(cfg: Config, model) -> None:
    """--resnet_weights (neo360_tpu/cli.py:177-199): copy a torchvision
    resnet34 state dict, or the npz of scripts/convert_weights.py, into
    the SpatialEncoder's backbone, every entry whose name and shape fit,
    and print how many arrays were loaded."""
    if not cfg.resnet_weights:
        return
    from neo360_tpu_torch.nn.resnet import load_pretrained
    encoder = model.encoder
    backbone = getattr(encoder, "spatial_encoder", encoder).backbone
    own = backbone.state_dict()
    fit = {k: v for k, v in load_pretrained(cfg.resnet_weights).items()
           if k in own and tuple(v.shape) == tuple(own[k].shape)}
    backbone.load_state_dict(fit, strict=False)
    print(f"loaded {len(fit)} pretrained ResNet34 arrays")


def _maybe_warm_start(cfg: Config, model) -> None:
    """--ckpt_path in training (neo360_tpu/cli.py:977-1002): splice the
    parameters and BatchNorm buffers of another run's checkpoint (either
    trainer's layout, or a port state_dict) or of a JAX npz into the fresh
    model. The optimizer state and the step start fresh."""
    if not cfg.ckpt_path:
        return
    if not os.path.exists(cfg.ckpt_path):
        raise FileNotFoundError(f"--ckpt_path {cfg.ckpt_path}: no checkpoint "
                                f"found for warm start")
    load_weights(model, cfg.ckpt_path)
    print(f"warm-started parameters and BatchNorm buffers from "
          f"{cfg.ckpt_path}")


def _split(group, n_rays: int) -> bool:
    """Whether a host batch of `n_rays` rays splits over the ranks of this
    rank's node (False outside a group)."""
    return group is not None and group.host_rows(n_rays)


def _rank_rays(batch: Dict, group, axis: int) -> Dict:
    """`batch` with its ray arrays (rays, viewdirs, target) cut to this
    rank's rows along `axis` (`sharding.shard_staged_batch` /
    `shard_stage_batch`: whole when the axis does not divide); the source
    stacks and scene ids stay whole, as the JAX mesh replicates them."""
    if group is None:
        return batch
    rays = {k: batch[k] for k in STAGE_RAY_KEYS if k in batch}
    return dict(batch, **sharding.shard_stage_batch(rays, group, axis))


def _per_step_runner(cfg: Config, model, lpips_model=None, group=None,
                     n_rays: int = 0):
    """(TrainState, staged runner) of the per-step trainer: one Adam with
    one global clip over every trained parameter (all of them, or all but
    the SpatialEncoder's in the optimize and finetune modes), BatchNorm
    statistics committed once per step. `group`: the data-parallel ranks,
    whose gradients the step averages; the loss sees them when a step's
    `n_rays` rays split over them."""
    from neo360_tpu_torch.train import loop as tl
    if frozen_encoder(cfg):
        freeze_spatial_encoder(model)
    loss_group = group if _split(group, n_rays) else None
    step_fn = tl.make_train_step(make_loss_fn(cfg, model,
                                              lpips_model=lpips_model,
                                              group=loss_group),
                                 with_model_state=True, group=group)
    state = tl.create_train_state(model,
                                  lambda params: build_optimizer(cfg, params))
    return state, tl.make_staged_trainer(step_fn)


def _run_warmup(cfg: Config, model, train_ds, device, logger) -> int:
    """--stage_warmup_steps (neo360_tpu/cli.py:822-857): the per-step
    trainer for ceil(stage_warmup_steps / per) calls of `per` =
    min(steps_per_call, stage_warmup_steps) steps before the first stage,
    its own Adam state, samples from seed + 7 and draws from seed + 9; the
    stage trainer then starts from the warmed weights with fresh optimizer
    states. Returns the steps done. In a data-parallel group each rank
    steps its rows of every batch."""
    from neo360_tpu_torch.train import loop as tl
    from neo360_tpu_torch.train.pipeline import to_device
    per = max(1, min(cfg.steps_per_call, cfg.stage_warmup_steps))
    n_calls = -(-cfg.stage_warmup_steps // per)
    group = sharding.current()
    state, staged = _per_step_runner(cfg, model, group=group,
                                     n_rays=cfg.ray_batch_size)
    rng = np.random.default_rng(cfg.seed + 7)
    generator = torch.Generator(device).manual_seed(cfg.seed + 9)
    if group is not None:
        generator = group.draws(generator,
                                _split(group, cfg.ray_batch_size))
    for _ in range(n_calls):
        samples = [train_ds.sample_train(rng) for _ in range(per)]
        batches = _rank_rays(tl.stack_batches(samples, STEP_KEYS), group, 1)
        metrics = staged(state, to_device(batches, device), generator)
        logger.log(state.step, {k: float(v) for k, v in metrics.items()})
    print(f"stage warmup: {state.step} per-step-encode steps done")
    return state.step


def _optimize_latents(model, train_ds, device) -> Dict[str, torch.Tensor]:
    """The optimize mode's run constant (neo360_tpu/cli.py:552-573): each
    scene's frozen SpatialEncoder latents of its fixed source stack,
    encoded once without grad with BatchNorm on its running statistics,
    stacked (S, NV, H/2, W/2, 512). Built from the model's weights as they
    stand, so run_train calls it after resume and warm start."""
    with torch.no_grad():
        lats = [model.encode_images(torch.as_tensor(
            train_ds.optimize_source_stack(s)["src_imgs"], device=device))
            for s in range(len(train_ds.scene_ids))]
    print(f"optimize mode: cached frozen spatial-encoder latents for "
          f"{len(lats)} scene(s); ResNet fwd+bwd dropped from the step")
    return {"pixel_latents": torch.stack(lats)}


def _validate_and_save(cfg: Config, state, step: int, render_fn, sample,
                       train_mode, logger, ckpt, device) -> None:
    """Render the validation `sample` with the model in eval mode, log its
    PSNR and val grid (utils.visualize.build_val_grid) at `step` and
    checkpoint the state there with the PSNR; the model's training mode is
    then `train_mode`."""
    from neo360_tpu_torch.train.metrics import psnr
    from neo360_tpu_torch.utils.visualize import build_val_grid
    state.model.eval()
    out = render_fn(sample)
    state.model.train(train_mode)
    w, h = cfg.img_wh
    target = torch.as_tensor(np.asarray(sample["target"]), device=device)
    val_psnr = float(psnr(out["rgb"].reshape(h, w, 3),
                          target.reshape(h, w, 3)))
    logger.log(step, {"val_psnr": val_psnr})
    if logger.primary:
        logger.log_image(step, "val_grid", build_val_grid(
            cfg.img_wh, np.asarray(sample["target"]).reshape(h, w, 3),
            {k: _host(v) for k, v in out.items()}))
    ckpt.save(step, checkpoint_payload(state) if ckpt.primary else None,
              {"val_psnr": val_psnr})


def _run_train_buffers(cfg: Config, model, device, datasets, logger, ckpt):
    """The vanilla and mipnerf360 branch of neo360_tpu/cli.py:run_train
    (601-652): every train ray of the scene in device buffers (with the
    pixel radii), `steps_per_call` steps of
    cfg.batch_size rays per call (`make_buffer_trainer`), one Adam over
    every parameter, metrics logged every call; when the step count
    crosses a multiple of save_every_steps, validation of the val split's
    image 0, its grid and a checkpoint. Resumes from the newest
    checkpoint. In a data-parallel group batch_size is rounded up to a
    multiple of the rank count and each rank steps its rows of every
    batch. Returns the TrainState."""
    from neo360_tpu_torch.data.nerds360 import NeRDS360
    from neo360_tpu_torch.train import loop as tl
    group = sharding.current()
    if group is not None:
        cfg = sharding.round_to_devices(cfg, "batch_size", group.world_size)
    if datasets is None:
        datasets = (NeRDS360(cfg.root_dir, "train", cfg.img_wh),
                    NeRDS360(cfg.root_dir, "val", cfg.img_wh))
    train_ds, val_ds = datasets
    buffers = train_ds.ray_buffers(device)
    state = tl.create_train_state(model,
                                  lambda params: build_optimizer(cfg, params))
    runner = tl.make_buffer_trainer(
        tl.make_train_step(make_loss_fn(cfg, model, group=group),
                           with_step=cfg.exp_type == "mipnerf360",
                           group=group),
        cfg.batch_size, cfg.steps_per_call, group)
    resume(ckpt, state)
    render_fn = make_render_fn(cfg, model, device)
    generator = torch.Generator(device).manual_seed(cfg.seed + 2)
    while state.step < cfg.run_max_steps:
        metrics = runner(state, buffers, generator)
        logger.log(state.step, {k: float(v) for k, v in metrics.items()})
        if state.step % cfg.save_every_steps < cfg.steps_per_call:
            _validate_and_save(cfg, state, state.step, render_fn,
                               val_ds.image_rays(0), True, logger, ckpt,
                               device)
    return state


def run_train(cfg: Config, device=None, datasets=None):
    """Train (neo360_tpu/cli.py:run_train, 575-819). vanilla and
    mipnerf360 run the ray-buffer trainer (`_run_train_buffers`); the
    few-shot models run the branch below.

    With stage_k <= 1 the per-step trainer runs `stage_size` steps per
    call (stage_size: min(steps_per_call, save_every_steps,
    run_max_steps)), each on one `sample_train` draw; with stage_k > 1 the
    scene-mixed encode-once stage trainer runs stage_size (rounded down to
    a multiple of stage_k) steps per call as n_stages stages, after
    `_run_warmup` when stage_warmup_steps > 0 and there is no checkpoint
    yet. The optimize and finetune modes always run the per-step trainer
    (`freeze_spatial_encoder`, the model in eval mode); optimize passes
    `_optimize_latents` to every step, keeps every checkpoint, and the
    finetune needs pretrained --lpips_weights (raises otherwise). Each
    call logs when the step count crosses a multiple of
    log_every_steps, and validates (view 0 of scene 0's held-out tail),
    logs the val grid and checkpoints when it crosses a multiple of
    save_every_steps. The stage trainer and the optimize mode's cached
    latents are NeO-360's; pixelnerf always runs the per-step trainer.
    `datasets`: (train, val) samplers to use instead of NeRDS360AE (vanilla,
    mipnerf360: NeRDS360) over cfg.root_dir. In a data-parallel group
    ray_batch_size is rounded up to a multiple of the node's rank count,
    every rank of a node draws the node's batches from the same seed and
    steps its rows of each (`_rank_rays`; its sampling draws are its rows
    of the batch's, `Group.draws`), and the trainers average the
    gradients (train/loop.py). Returns the TrainState or
    SceneStageState."""
    from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE
    from neo360_tpu_torch.models.neo360 import SRC_KEYS as MODEL_SRC_KEYS
    from neo360_tpu_torch.models.neo360 import make_scene_stage_fns
    from neo360_tpu_torch.nn.lpips import LPIPSModel
    from neo360_tpu_torch.train import loop as tl
    from neo360_tpu_torch.train.checkpoints import CheckpointManager
    from neo360_tpu_torch.train.logging import MetricsLogger
    from neo360_tpu_torch.train.pipeline import prefetch_to_device

    group = sharding.current()
    if group is not None and cfg.exp_type not in SINGLE_SCENE:
        cfg = sharding.round_to_devices(cfg, "ray_batch_size",
                                        group.local_world_size)
    _check_train_mode(cfg)
    device = resolve_device(cfg, device)
    float32_matmuls(cfg, device)
    lpips_model = None
    if cfg.finetune_lpips:
        lpips_model = LPIPSModel(cfg.lpips_weights).to(device)
    if cfg.finetune_lpips and not lpips_model.pretrained:
        # stage 2 is the LPIPS loss: without the weights it would run
        # stage 1 at the pinned lr
        raise ValueError("--finetune_lpips requires pretrained LPIPS "
                         "weights: pass --lpips_weights <pt|npz> (see "
                         "scripts/convert_weights.py)")
    frozen = frozen_encoder(cfg)
    exp_dir = os.path.join(cfg.ckpt_dir, cfg.exp_name)
    logger = MetricsLogger(exp_dir)
    ckpt = CheckpointManager(os.path.join(exp_dir, "checkpoints"),
                             keep_all=cfg.is_optimize)
    model = build_model(cfg, device).train(not frozen)
    _maybe_load_resnet(cfg, model)
    _maybe_warm_start(cfg, model)
    neo360 = cfg.exp_type in ("neo360", "neo360_fast")
    if cfg.exp_type in SINGLE_SCENE:
        state = _run_train_buffers(cfg, model, device, datasets, logger,
                                   ckpt)
        logger.close()
        return state
    if datasets is None:
        node = (0, 1) if group is None else (group.node, group.nodes)
        datasets = (NeRDS360AE(cfg.root_dir, "train", cfg.img_wh,
                               cfg.num_src_views, cfg.ray_batch_size,
                               optimize=cfg.is_optimize,
                               finetune_lpips=cfg.finetune_lpips,
                               process_index=node[0],
                               process_count=node[1]),
                    NeRDS360AE(cfg.root_dir, "val", cfg.img_wh,
                               cfg.num_src_views))
    train_ds, val_ds = datasets

    stage_size = max(1, min(cfg.steps_per_call, cfg.save_every_steps,
                            cfg.run_max_steps))
    use_stage = cfg.stage_k > 1 and not frozen and neo360
    warm_steps = 0
    if use_stage:
        if cfg.stage_warmup_steps > 0 and ckpt.latest_step() is None:
            warm_steps = _run_warmup(cfg, model, train_ds, device, logger)
        stage_size = max(cfg.stage_k, stage_size - stage_size % cfg.stage_k)
        n_stages = stage_size // cfg.stage_k
        encode_fn, loss_fn = make_scene_stage_fns(
            model, white_bkgd=cfg.white_back, mixed=cfg.stage_scenes > 1)
        # each partition gets its own optimizer at the base lr: the
        # encoder's steps once per stage, so its schedule advances once per
        # stage
        state = tl.create_scene_stage_state(
            model, lambda params: build_optimizer(cfg, params))
        state.step = warm_steps
        runner = tl.make_scene_stage_trainer(
            encode_fn, loss_fn, multi_stage=True,
            cot_dtype=getattr(torch, cfg.stage_cot_dtype), group=group)
        # the rays of one scene of a step; axis 3 of (n_stages, K, S, B/S)
        n_rays = cfg.ray_batch_size // cfg.stage_scenes
        ray_axis = 3 if cfg.stage_scenes > 1 else 2
    else:
        n_rays = (train_ds.patch_size ** 2 if cfg.finetune_lpips
                  else cfg.ray_batch_size)
        state, runner = _per_step_runner(cfg, model, lpips_model, group,
                                         n_rays)
    start_step = max(resume(ckpt, state), warm_steps)
    const = (_optimize_latents(model, train_ds, device)
             if cfg.is_optimize and neo360 else None)
    step_keys = STEP_KEYS + (("scene_idx",) if const is not None else ())

    def staged_iterator():
        rng = np.random.default_rng(cfg.seed)
        while True:
            if use_stage:
                stages = [train_ds.sample_train_stage(
                              rng, cfg.stage_k, n_scenes=cfg.stage_scenes)
                          for _ in range(n_stages)]
                yield (tl.stack_batches(stages, MODEL_SRC_KEYS),
                       _rank_rays(tl.stack_batches(stages, STAGE_RAY_KEYS),
                                  group, ray_axis))
            else:
                samples = [train_ds.sample_train(rng)
                           for _ in range(stage_size)]
                yield (_rank_rays(tl.stack_batches(samples, step_keys),
                                  group, 1),)

    render_fn = make_render_fn(cfg, model, device)
    generator = torch.Generator(device).manual_seed(cfg.seed + 2)
    if group is not None:
        generator = group.draws(generator, _split(group, n_rays))
    step = start_step
    with prefetch_to_device(staged_iterator(), size=2,
                            device=device) as it:
        for batches in it:
            if step >= cfg.run_max_steps:
                break
            if use_stage:
                metrics = runner(state, *batches, generator)
            else:
                metrics = runner(state, *batches, generator, const)
            step += stage_size
            if step % cfg.log_every_steps < stage_size:
                logger.log(step, {k: float(v) for k, v in metrics.items()})
            if step > 0 and step % cfg.save_every_steps < stage_size:
                _validate_and_save(cfg, state, step, render_fn,
                                   val_ds.sample_val(0), not frozen, logger,
                                   ckpt, device)
    logger.close()
    return state


def _run(cfg: Config):
    if cfg.eval_mode is not None:
        return run_eval(cfg)
    return run_train(cfg)


def _run_rank(cfg: Config):
    """One data-parallel rank of `main`: its eval summary, or its training
    step count."""
    out = _run(cfg)
    return out if cfg.eval_mode is not None else out.step


def main(argv=None, world_size: Optional[int] = None):
    """Parse `argv` and train or evaluate. Under torchrun (RANK and
    WORLD_SIZE set) this process joins torchrun's group. Otherwise
    `world_size` ranks (default: one per visible card for a CUDA --device,
    else one) run it: more than one are started here, one process each
    (`sharding.launch`), and rank 0's eval summary or training step count
    is returned; one runs in this process and returns the eval summary or
    the train state, as the JAX CLI does."""
    cfg = parse_args(argv)
    device_type = torch.device(cfg.device).type
    if sharding.torchrun_env() and sharding.current() is None:
        group = sharding.init_from_env(device_type)
        if group.primary:
            print(f"data-parallel over {group.world_size} devices")
        try:
            return _run_rank(cfg)
        finally:
            sharding.destroy()
    if world_size is None:
        world_size = (torch.cuda.device_count() if device_type == "cuda"
                      else 1)
    if world_size > 1:
        print(f"data-parallel over {world_size} devices")
        return sharding.launch(_run_rank, world_size, cfg,
                               device=cfg.device)[0]
    return _run(cfg)


if __name__ == "__main__":
    main()
