"""Command-line runner for the port (the eval half of neo360_tpu/cli.py).

Usage:
    python -m neo360_tpu_torch.cli --exp_type neo360_fast --root_dir <scenes> \
        --eval_mode full_eval [--ckpt_path model.pt|variables.npz]

Renders every test view of every scene under root_dir with the few-shot
`neo360_fast` model: each scene's source stack is encoded once, then views
are rendered in `--chunk`-ray tiles; PSNR / SSIM (+ object PSNR) go to
<ckpt_dir>/<exp_name>/results.json and images to .../<render_name>/.
Weights come from a port checkpoint (a torch state_dict), a JAX-exported
npz (neo360_tpu/utils/io.py:save_variables_npz, converted by weights.py),
or, with neither, a seeded random init (with a warning).
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


def parse_args(argv=None) -> Config:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp_type", required=True)
    p.add_argument("--root_dir", required=True)
    p.add_argument("--exp_name", default="exp")
    p.add_argument("--img_wh", nargs=2, type=int, default=[320, 240])
    p.add_argument("--white_back", action="store_true")
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--num_src_views", type=int, default=None)
    p.add_argument("--eval_mode", choices=["full_eval"], default=None)
    p.add_argument("--render_name", default="3views")
    p.add_argument("--ckpt_dir", default="ckpts")
    p.add_argument("--ckpt_path", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_bn_mode", choices=["batch", "running"],
                   default=None)
    a = p.parse_args(argv)
    # the source-view count rides the render_name's leading digit
    if a.num_src_views is None and a.render_name[:1].isdigit():
        a.num_src_views = int(a.render_name[0])
    overrides = {k: v for k, v in vars(a).items()
                 if v is not None and k not in ("exp_type", "img_wh")}
    return preset(a.exp_type, img_wh=tuple(a.img_wh), **overrides)


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
    """Load weights into `model` from cfg.ckpt_path or <exp_dir>/model.pt:
    a `.npz` is a JAX export (weights.from_flax_flat), anything else a port
    state_dict. Returns the path loaded, or None (random init)."""
    path = cfg.ckpt_path or os.path.join(exp_dir, "model.pt")
    if not os.path.exists(path):
        if cfg.ckpt_path:
            raise FileNotFoundError(f"--ckpt_path {path}: no such file")
        return None
    if path.endswith(".npz"):
        sd = weights.from_flax_flat(weights.load_variables_npz(path))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    weights.load_into(model, sd)
    return path


def run_eval(cfg: Config, device=None) -> Dict[str, float]:
    from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE
    from neo360_tpu_torch.train.eval import evaluate_and_save

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
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


def main(argv=None):
    cfg = parse_args(argv)
    if cfg.eval_mode is None:
        raise NotImplementedError("training is not ported yet: pass "
                                  "--eval_mode full_eval")
    return run_eval(cfg)


if __name__ == "__main__":
    main()
