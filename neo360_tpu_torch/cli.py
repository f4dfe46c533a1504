"""Command-line runner for the port (neo360_tpu/cli.py, `neo360_fast`).

Usage:
    python -m neo360_tpu_torch.cli --exp_type neo360_fast --root_dir <scenes>
    python -m neo360_tpu_torch.cli --exp_type neo360_fast --root_dir <scenes> \
        --eval_mode full_eval [--ckpt_path model.pt|ckpt_*.pt|variables.npz]

Without --eval_mode it trains with the scene-mixed, encode-once stage
trainer (K=32 steps per stage, S=2 scenes per step): metrics go to
<ckpt_dir>/<exp_name>/metrics.jsonl, checkpoints to
<ckpt_dir>/<exp_name>/checkpoints/, and a run resumes from the newest one.
With --eval_mode full_eval it renders every test view of every scene under
root_dir: each scene's source stack is encoded once, then views are
rendered in `--chunk`-ray tiles; PSNR / SSIM (+ object PSNR) go to
<ckpt_dir>/<exp_name>/results.json and images to .../<render_name>/.
Eval weights come from --ckpt_path (a port state_dict, a training
checkpoint or a JAX-exported npz, neo360_tpu/utils/io.py:
save_variables_npz, converted by weights.py), else <exp_dir>/model.pt,
else the newest training checkpoint, else a seeded random init (with a
warning). Both run on --device (default cuda) and raise when it is absent.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np
import torch

from neo360_tpu_torch import weights
from neo360_tpu_torch.config import Config, preset

SRC_KEYS = ("src_imgs", "src_poses", "src_focal", "src_c")
RAY_KEYS = ("rays_o", "rays_d", "viewdirs")
STAGE_RAY_KEYS = ("rays_o", "rays_d", "viewdirs", "target")


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


def build_optimizer(cfg: Config, params):
    """Adam on the warm-up-sine x log-lerp schedule, clipped to
    cfg.grad_max_norm (neo360_tpu/cli.py:139-174, normal training): the
    `optax.chain(clip_by_global_norm, adam(nerf_schedule))` of the JAX CLI
    over `params` alone, so each partition clips to its own norm."""
    from neo360_tpu_torch.train.optim import Adam
    from neo360_tpu_torch.train.schedules import nerf_schedule
    if cfg.is_optimize or cfg.finetune_lpips:
        raise NotImplementedError("optimize / finetune modes are not ported")
    sched = nerf_schedule(cfg.lr_init, cfg.lr_final, cfg.run_max_steps,
                          cfg.lr_delay_steps, cfg.lr_delay_mult)
    return Adam(params, sched, max_norm=cfg.grad_max_norm)


def resolve_device(cfg: Config, device=None) -> torch.device:
    """`device` or cfg.device; raise if it is a CUDA device and there is
    none (no silent fall back to the CPU)."""
    dev = torch.device(device or cfg.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available; pass --device cpu to run on the CPU")
    return dev


def build_model(cfg: Config, device="cpu"):
    """The `neo360_fast` NeRFTP on `device`, initialised from cfg.seed."""
    if cfg.exp_type != "neo360_fast":
        raise NotImplementedError(
            f"exp_type {cfg.exp_type!r}: only neo360_fast is ported")
    from neo360_tpu_torch.models.neo360 import NeRFTP
    size = {k: v for k, v in (("encoder_width", cfg.encoder_width),)
            if v is not None}
    model = NeRFTP(
        num_src_views=cfg.num_src_views,
        compute_dtype=torch.bfloat16 if cfg.bf16 else torch.float32,
        num_prop_samples=cfg.num_prop_samples or 64,
        num_fine_samples=cfg.num_fine_samples or 64,
        lift_dim=cfg.lift_dim,
        grid_size=tuple(cfg.grid_size or (64, 64, 32)),
        generator=torch.Generator().manual_seed(cfg.seed), **size)
    return model.to(device).eval()


def make_render_fn(cfg: Config, model, device="cpu"):
    """render_fn(sample) -> {"rgb", "depth", "fg_rgb", "bg_rgb", "fg_acc",
    "bg_acc"} over a full image of rays.

    The source stack is encoded once per scene: samples carrying the same
    "scene_key" reuse the previous encode (one scene resident at a time);
    a sample without one is encoded anew."""
    from neo360_tpu_torch.train.loop import make_image_renderer
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


def restore(cfg: Config, model, exp_dir: str) -> Optional[str]:
    """Load weights into `model` from cfg.ckpt_path, else <exp_dir>/model.pt,
    else the newest training checkpoint in <exp_dir>/checkpoints: a `.npz`
    is a JAX export (weights.from_flax_flat), a training checkpoint gives
    its merged partitions and BatchNorm buffers, anything else is a port
    state_dict. Returns the path loaded, or None (random init)."""
    from neo360_tpu_torch.train.checkpoints import CheckpointManager
    path = cfg.ckpt_path or os.path.join(exp_dir, "model.pt")
    if not os.path.exists(path):
        if cfg.ckpt_path:
            raise FileNotFoundError(f"--ckpt_path {path}: no such file")
        mgr = CheckpointManager(os.path.join(exp_dir, "checkpoints"))
        if mgr.latest_step() is None:
            return None
        path = mgr.path(mgr.latest_step())
    if path.endswith(".npz"):
        sd = weights.from_flax_flat(weights.load_variables_npz(path))
    else:
        sd = weights.from_checkpoint(
            torch.load(path, map_location="cpu", weights_only=True))
    weights.load_into(model, sd)
    return path


def run_eval(cfg: Config, device=None) -> Dict[str, float]:
    from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE
    from neo360_tpu_torch.train.eval import evaluate_and_save

    device = resolve_device(cfg, device)
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
    summary = evaluate_and_save(
        render_fn, samples, cfg.img_wh,
        os.path.join(exp_dir, cfg.render_name),
        results_json=os.path.join(exp_dir, "results.json"),
        extra={"eval_bn_mode": cfg.eval_bn_mode})
    print("eval summary:", summary)
    return summary


def _check_train_mode(cfg: Config) -> None:
    """Raise on the training modes the port does not have yet."""
    unported = [name for name, on in (
        ("--is_optimize", cfg.is_optimize),
        ("--finetune_lpips", cfg.finetune_lpips),
        ("--lpips_weights", cfg.lpips_weights),
        ("--resnet_weights", cfg.resnet_weights),
        ("--stage_warmup_steps > 0", cfg.stage_warmup_steps > 0),
        ("--stage_k <= 1 (the per-step trainer)", cfg.stage_k <= 1)) if on]
    if unported:
        raise NotImplementedError(f"not ported: {', '.join(unported)}; the "
                                  f"port trains neo360_fast with the scene-"
                                  f"stage trainer only")
    if cfg.ray_batch_size % cfg.stage_scenes:
        raise ValueError(f"ray_batch_size {cfg.ray_batch_size} must divide "
                         f"by stage_scenes {cfg.stage_scenes}")


def checkpoint_payload(state) -> Dict:
    """Both parameter partitions, both Adam states, the step and the
    BatchNorm buffers of a SceneStageState, on the CPU."""
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    return {"step": state.step, "enc_params": cpu(state.enc_params),
            "ray_params": cpu(state.ray_params),
            "batch_stats": cpu(dict(state.model.named_buffers())),
            "enc_opt": state.enc_opt.state_dict(),
            "ray_opt": state.ray_opt.state_dict()}


def resume(ckpt, state) -> int:
    """Load the newest checkpoint of `ckpt` into `state`; returns its step
    (0 without one)."""
    raw = ckpt.restore()
    if raw is None:
        return 0
    weights.load_into(state.model, weights.from_checkpoint(raw))
    state.enc_opt.load_state_dict(raw["enc_opt"])
    state.ray_opt.load_state_dict(raw["ray_opt"])
    state.step = int(raw["step"])
    print(f"resumed from checkpoint step {state.step}")
    return state.step


def run_train(cfg: Config, device=None, datasets=None):
    """Train `neo360_fast` with the scene-mixed, encode-once stage trainer
    (the stage branch of neo360_tpu/cli.py:run_train, 575-819).

    Each iteration runs `stage_size` steps as n_stages stages of stage_k
    steps (stage_size: min(steps_per_call, save_every_steps, run_max_steps)
    rounded down to a multiple of stage_k); it logs when the step count
    crosses a multiple of log_every_steps, and validates (view 0 of scene
    0's held-out tail), logs the val grid and checkpoints when it crosses
    a multiple of save_every_steps. `datasets`: (train, val) samplers to
    use instead of NeRDS360AE over cfg.root_dir. Returns the
    SceneStageState."""
    import numpy as np

    from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE
    from neo360_tpu_torch.models.neo360 import SRC_KEYS as MODEL_SRC_KEYS
    from neo360_tpu_torch.models.neo360 import make_scene_stage_fns
    from neo360_tpu_torch.train import loop as tl
    from neo360_tpu_torch.train.checkpoints import CheckpointManager
    from neo360_tpu_torch.train.logging import MetricsLogger
    from neo360_tpu_torch.train.metrics import psnr
    from neo360_tpu_torch.train.pipeline import prefetch_to_device
    from neo360_tpu_torch.utils.visualize import visualize_val_fg_bg_opacity

    _check_train_mode(cfg)
    device = resolve_device(cfg, device)
    exp_dir = os.path.join(cfg.ckpt_dir, cfg.exp_name)
    logger = MetricsLogger(exp_dir)
    ckpt = CheckpointManager(os.path.join(exp_dir, "checkpoints"))
    model = build_model(cfg, device).train()
    if datasets is None:
        datasets = (NeRDS360AE(cfg.root_dir, "train", cfg.img_wh,
                               cfg.num_src_views, cfg.ray_batch_size),
                    NeRDS360AE(cfg.root_dir, "val", cfg.img_wh,
                               cfg.num_src_views))
    train_ds, val_ds = datasets

    stage_size = max(1, min(cfg.steps_per_call, cfg.save_every_steps,
                            cfg.run_max_steps))
    stage_size = max(cfg.stage_k, stage_size - stage_size % cfg.stage_k)
    n_stages = stage_size // cfg.stage_k
    encode_fn, loss_fn = make_scene_stage_fns(
        model, white_bkgd=cfg.white_back, mixed=cfg.stage_scenes > 1)
    # each partition gets its own optimizer at the base lr: the encoder's
    # steps once per stage, so its schedule advances once per stage
    state = tl.create_scene_stage_state(
        model, lambda params: build_optimizer(cfg, params))
    runner = tl.make_scene_stage_trainer(
        encode_fn, loss_fn, multi_stage=True,
        cot_dtype=getattr(torch, cfg.stage_cot_dtype))
    start_step = resume(ckpt, state)

    def staged_iterator():
        rng = np.random.default_rng(cfg.seed)
        while True:
            stages = [train_ds.sample_train_stage(rng, cfg.stage_k,
                                                  n_scenes=cfg.stage_scenes)
                      for _ in range(n_stages)]
            yield (tl.stack_batches(stages, MODEL_SRC_KEYS),
                   tl.stack_batches(stages, STAGE_RAY_KEYS))

    render_fn = make_render_fn(cfg, model, device)
    generator = torch.Generator(device).manual_seed(cfg.seed + 2)
    step = start_step
    with prefetch_to_device(staged_iterator(), size=2,
                            device=device) as it:
        for srcs, rays in it:
            if step >= cfg.run_max_steps:
                break
            metrics = runner(state, srcs, rays, generator)
            step += stage_size
            if step % cfg.log_every_steps < stage_size:
                logger.log(step, {k: float(v) for k, v in metrics.items()})
            if step > 0 and step % cfg.save_every_steps < stage_size:
                sample = val_ds.sample_val(0)
                model.eval()
                out = render_fn(sample)
                model.train()
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
