"""Command-line runner for the port (neo360_tpu/cli.py; the `neo360` and
`neo360_fast` presets).

Usage:
    python -m neo360_tpu_torch.cli --exp_type neo360 --root_dir <scenes>
    python -m neo360_tpu_torch.cli --exp_type neo360_fast --root_dir <scenes>
    python -m neo360_tpu_torch.cli --exp_type neo360 --root_dir <scenes> \
        --eval_mode full_eval [--ckpt_path model.pt|ckpt_*.pt|variables.npz]

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
With --eval_mode full_eval it renders every test view of every scene under
root_dir: each scene's source stack is encoded once, then views are
rendered in `--chunk`-ray tiles; PSNR / SSIM (+ object PSNR) go to
<ckpt_dir>/<exp_name>/results.json and images to .../<render_name>/.
Eval weights come from --ckpt_path (a port state_dict, a training
checkpoint of either layout or a JAX-exported npz, neo360_tpu/utils/io.py:
save_variables_npz, converted by weights.py), else <exp_dir>/model.pt,
else the newest training checkpoint, else a seeded random init (with a
warning); with --lpips_weights each view's LPIPS is reported too. Both
run on --device (default cuda) and raise when it is absent; a float32
model on the card runs with TF32 off.
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
from neo360_tpu_torch.train.loop import TrainState

SRC_KEYS = ("src_imgs", "src_poses", "src_focal", "src_c")
RAY_KEYS = ("rays_o", "rays_d", "viewdirs")
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
    p.add_argument("--eval_mode", choices=["full_eval"], default=None)
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
    `set_to_zero` partition)."""
    model.encoder.spatial_encoder.requires_grad_(False)


def resolve_device(cfg: Config, device=None) -> torch.device:
    """`device` or cfg.device; raise if it is a CUDA device and there is
    none (no silent fall back to the CPU)."""
    dev = torch.device(device or cfg.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available; pass --device cpu to run on the CPU")
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
    """The `neo360` or `neo360_fast` NeRFTP on `device` (default
    cfg.device, see `resolve_device`), initialised from cfg.seed.

    neo360 (neo360_tpu/cli.py:117-124): the conditioned coarse level,
    cfg.num_coarse_samples or 128 coarse and cfg.num_fine_samples or 256
    fine samples, grid cfg.grid_size or (64, 64, 64), the encoder's grid
    part recomputed in the backward unless cfg.remat_encoder is False.
    neo360_fast: the proposal level, 64 proposal and cfg.num_fine_samples
    or 64 fine samples, grid (64, 64, 32), no recompute. Compute is bf16
    with cfg.bf16, else float32 (see `float32_matmuls` for TF32)."""
    if cfg.exp_type not in ("neo360", "neo360_fast"):
        raise NotImplementedError(
            f"exp_type {cfg.exp_type!r}: only neo360 and neo360_fast are "
            f"ported")
    device = resolve_device(cfg, device)
    from neo360_tpu_torch.models.neo360 import NeRFTP
    size = {k: v for k, v in (("encoder_width", cfg.encoder_width),)
            if v is not None}
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
                    remat_encoder=False)
    model = NeRFTP(
        num_src_views=cfg.num_src_views,
        compute_dtype=torch.bfloat16 if cfg.bf16 else torch.float32,
        lift_dim=cfg.lift_dim,
        generator=torch.Generator().manual_seed(cfg.seed), **size)
    return model.to(device).eval()


def make_render_fn(cfg: Config, model, device=None):
    """render_fn(sample) -> {"rgb", "depth", "fg_rgb", "bg_rgb", "fg_acc",
    "bg_acc"} over a full image of rays, with the sample's arrays placed on
    `device` (default cfg.device, see `resolve_device`).

    The source stack is encoded once per scene: samples carrying the same
    "scene_key" reuse the previous encode (one scene resident at a time);
    a sample without one is encoded anew."""
    from neo360_tpu_torch.train.loop import make_image_renderer
    device = resolve_device(cfg, device)
    batch_stats = cfg.eval_bn_mode == "batch"

    def render_chunk(pack, rays):
        out = model(dict(rays, **pack["src"]), pack["enc"], cfg.white_back,
                    out_depth=True)[1]
        return {k: out[k] for k in ("rgb", "depth", "fg_rgb", "bg_rgb",
                                    "fg_acc", "bg_acc")}

    renderer = make_image_renderer(render_chunk, cfg.chunk)
    cache: Dict = {}

    @torch.inference_mode()
    def get_pack(sample):
        key = sample.get("scene_key")
        if key is not None and key in cache:
            return cache[key]
        src = {k: torch.as_tensor(np.asarray(sample[k]), device=device)
               for k in SRC_KEYS}
        enc = model.encode(src["src_imgs"], src["src_poses"],
                           src["src_focal"], src["src_c"], batch_stats)
        pack = {"src": src, "enc": enc}
        cache.clear()
        if key is not None:
            cache[key] = pack
        return pack

    def render_fn(sample):
        pack = get_pack(sample)
        rays = {k: torch.as_tensor(np.asarray(sample[k]), device=device)
                for k in RAY_KEYS}
        return renderer(pack, rays)

    return render_fn


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


def run_eval(cfg: Config, device=None) -> Dict[str, float]:
    from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE
    from neo360_tpu_torch.train.eval import evaluate_and_save
    from neo360_tpu_torch.train.pipeline import prefetch_to_device

    from neo360_tpu_torch.nn.lpips import LPIPSModel

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
    print(f"eval encode BN mode: {cfg.eval_bn_mode}")

    test_ds = NeRDS360AE(cfg.root_dir, "test", cfg.img_wh, cfg.num_src_views)
    render_fn = make_render_fn(cfg, model, device)
    samples = (dict(test_ds.sample_test(s, d), scene_key=s)
               for s in range(len(test_ds.scene_ids))
               for d in range(test_ds.num_test_views(s)))
    # each view's rays and target are made on a worker thread while the
    # previous view renders; render_fn places them on the device
    with prefetch_to_device(samples, size=2, device=None) as samples:
        summary = evaluate_and_save(
            render_fn, samples, cfg.img_wh,
            os.path.join(exp_dir, cfg.render_name),
            results_json=os.path.join(exp_dir, "results.json"),
            extra={"eval_bn_mode": cfg.eval_bn_mode},
            lpips_model=lpips_model)
    print("eval summary:", summary)
    return summary


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
    BatchNorm buffers and, for a TrainState (the per-step trainer), all
    parameters (the frozen ones too) and the one Adam state of the trained
    ones; for a SceneStageState both parameter partitions and both Adam
    states."""
    out = {"step": state.step,
           "batch_stats": _cpu(dict(state.model.named_buffers()))}
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
                 lpips_model=None):
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
    is added; the batch must then be a square patch (raises otherwise)."""
    from neo360_tpu_torch.models.neo360 import RAY_KEYS as MODEL_RAY_KEYS
    from neo360_tpu_torch.models.neo360 import SRC_KEYS as MODEL_SRC_KEYS
    from neo360_tpu_torch.models.neo360 import training_loss
    from neo360_tpu_torch.ops.losses import mse2psnr
    train_bn = not frozen_encoder(cfg)
    use_lpips = (cfg.finetune_lpips and lpips_model is not None
                 and lpips_model.pretrained)

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
            n = batch["target"].shape[0]
            side = math.isqrt(n)
            if side * side != n:
                raise ValueError(f"the LPIPS patch loss needs a square ray "
                                 f"batch (patch_size**2), got {n} rays")
            pred, gt = (torch.clamp(t, 0, 1).reshape(1, side, side, 3)
                        for t in (out[1]["rgb"], batch["target"]))
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
    backbone = model.encoder.spatial_encoder.backbone
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


def _per_step_runner(cfg: Config, model, lpips_model=None):
    """(TrainState, staged runner) of the per-step trainer: one Adam with
    one global clip over every trained parameter (all of them, or all but
    the SpatialEncoder's in the optimize and finetune modes), BatchNorm
    statistics committed once per step."""
    from neo360_tpu_torch.train import loop as tl
    if frozen_encoder(cfg):
        freeze_spatial_encoder(model)
    step_fn = tl.make_train_step(make_loss_fn(cfg, model,
                                              lpips_model=lpips_model),
                                 with_model_state=True)
    state = tl.create_train_state(model,
                                  lambda params: build_optimizer(cfg, params))
    return state, tl.make_staged_trainer(step_fn)


def _run_warmup(cfg: Config, model, train_ds, device, logger) -> int:
    """--stage_warmup_steps (neo360_tpu/cli.py:822-857): the per-step
    trainer for ceil(stage_warmup_steps / per) calls of `per` =
    min(steps_per_call, stage_warmup_steps) steps before the first stage,
    its own Adam state, samples from seed + 7 and draws from seed + 9; the
    stage trainer then starts from the warmed weights with fresh optimizer
    states. Returns the steps done."""
    from neo360_tpu_torch.train import loop as tl
    from neo360_tpu_torch.train.pipeline import to_device
    per = max(1, min(cfg.steps_per_call, cfg.stage_warmup_steps))
    n_calls = -(-cfg.stage_warmup_steps // per)
    state, staged = _per_step_runner(cfg, model)
    rng = np.random.default_rng(cfg.seed + 7)
    generator = torch.Generator(device).manual_seed(cfg.seed + 9)
    for _ in range(n_calls):
        samples = [train_ds.sample_train(rng) for _ in range(per)]
        metrics = staged(state, to_device(
            tl.stack_batches(samples, STEP_KEYS), device), generator)
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


def run_train(cfg: Config, device=None, datasets=None):
    """Train (the few-shot branch of neo360_tpu/cli.py:run_train, 575-819).

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
    save_every_steps. `datasets`: (train, val) samplers to use instead of
    NeRDS360AE over cfg.root_dir. Returns the TrainState or
    SceneStageState."""
    from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE
    from neo360_tpu_torch.models.neo360 import SRC_KEYS as MODEL_SRC_KEYS
    from neo360_tpu_torch.models.neo360 import make_scene_stage_fns
    from neo360_tpu_torch.nn.lpips import LPIPSModel
    from neo360_tpu_torch.train import loop as tl
    from neo360_tpu_torch.train.checkpoints import CheckpointManager
    from neo360_tpu_torch.train.logging import MetricsLogger
    from neo360_tpu_torch.train.metrics import psnr
    from neo360_tpu_torch.train.pipeline import prefetch_to_device
    from neo360_tpu_torch.utils.visualize import visualize_val_fg_bg_opacity

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
    if datasets is None:
        datasets = (NeRDS360AE(cfg.root_dir, "train", cfg.img_wh,
                               cfg.num_src_views, cfg.ray_batch_size,
                               optimize=cfg.is_optimize,
                               finetune_lpips=cfg.finetune_lpips),
                    NeRDS360AE(cfg.root_dir, "val", cfg.img_wh,
                               cfg.num_src_views))
    train_ds, val_ds = datasets

    stage_size = max(1, min(cfg.steps_per_call, cfg.save_every_steps,
                            cfg.run_max_steps))
    use_stage = cfg.stage_k > 1 and not frozen
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
            cot_dtype=getattr(torch, cfg.stage_cot_dtype))
    else:
        state, runner = _per_step_runner(cfg, model, lpips_model)
    start_step = max(resume(ckpt, state), warm_steps)
    const = (_optimize_latents(model, train_ds, device) if cfg.is_optimize
             else None)
    step_keys = STEP_KEYS + (("scene_idx",) if const is not None else ())

    def staged_iterator():
        rng = np.random.default_rng(cfg.seed)
        while True:
            if use_stage:
                stages = [train_ds.sample_train_stage(
                              rng, cfg.stage_k, n_scenes=cfg.stage_scenes)
                          for _ in range(n_stages)]
                yield (tl.stack_batches(stages, MODEL_SRC_KEYS),
                       tl.stack_batches(stages, STAGE_RAY_KEYS))
            else:
                samples = [train_ds.sample_train(rng)
                           for _ in range(stage_size)]
                yield (tl.stack_batches(samples, step_keys),)

    render_fn = make_render_fn(cfg, model, device)
    generator = torch.Generator(device).manual_seed(cfg.seed + 2)
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
                sample = val_ds.sample_val(0)
                model.eval()
                out = render_fn(sample)
                model.train(not frozen)
                w, h = cfg.img_wh
                target = torch.as_tensor(sample["target"], device=device)
                val_psnr = float(psnr(out["rgb"].reshape(h, w, 3),
                                      target.reshape(h, w, 3)))
                logger.log(step, {"val_psnr": val_psnr})
                host = {k: v.float().cpu().numpy() for k, v in out.items()}
                logger.log_image(step, "val_grid", visualize_val_fg_bg_opacity(
                    cfg.img_wh, sample["target"], host["rgb"],
                    host["fg_rgb"], host["bg_rgb"], host["fg_acc"],
                    host["bg_acc"]))
                ckpt.save(step, checkpoint_payload(state),
                          {"val_psnr": val_psnr})
    logger.close()
    return state


def main(argv=None):
    cfg = parse_args(argv)
    if cfg.eval_mode is not None:
        return run_eval(cfg)
    return run_train(cfg)


if __name__ == "__main__":
    main()
