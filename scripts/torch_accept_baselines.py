#!/usr/bin/env python3
"""Acceptance of the port's vanilla NeRF, MipNeRF-360 and PixelNeRF: train
each through the port's CLI by the JAX package's acceptance protocol
(scripts/accept_vanilla.py, scripts/accept_mip_pixelnerf.py, cut nowhere)
and hold its test quality to the JAX package's numbers, less 2.0 dB PSNR
and 0.02 SSIM.

    python3 scripts/torch_accept_baselines.py PHASE [--state DIR]
        [--steps N] [--device cuda|cpu]

Phases, each through `neo360_tpu_torch.cli.run_train` / `run_eval` only,
each printing one JSON line (also appended to <state>/accept.jsonl):

- vanilla_train: `--exp_type vanilla` (ray-buffer trainer, 2048 rays a
  step, 100 steps a call) on a 320x240 micro scene to --steps (default
  30,000), a validation render and checkpoint every steps / 4; resumes
  from the newest checkpoint under <state>.
- vanilla_eval: `full_eval` of the newest checkpoint on the scene's 5
  test views; the bar: PSNR >= 35.09 and SSIM >= 0.967 (JAX: 37.09 /
  0.987, BASELINE.md:181-190).
- mip_train: `--exp_type mipnerf360` (ray-buffer trainer, 2048 rays a
  step, 500 steps a call, float32) on a 320x240 micro scene to --steps
  (default 20,000), a validation render and checkpoint every steps / 3;
  resumes likewise.
- mip_eval: `full_eval` (4096-ray tiles) of the newest checkpoint on the
  scene's 5 test views; the bar: PSNR >= 35.05 and SSIM >= 0.968 (JAX:
  37.05 / 0.988, BASELINE.md:496-511).
- pixelnerf_train: `--exp_type pixelnerf` (per-step trainer, 512 rays a
  step, bf16, 100 steps a call) on a 3-scene 320x240 root with 3 test
  views a scene to --steps (default 20,000), a validation render and
  checkpoint every steps / 3; resumes likewise.
- pixelnerf_eval: `full_eval` (1024-ray tiles) of the newest checkpoint
  on every test view, BatchNorm on the source stack's statistics
  ("batch", the JAX acceptance's mode) and on the running ones; the bar:
  PSNR >= 29.31 and SSIM >= 0.950 (JAX: 31.31 / 0.970,
  BASELINE.md:514-532).

The scenes are written by the port's own `make_micro_scene` /
`make_multi_scene_root` (the same bytes as the JAX package's) under
<state> when they are missing. A train line gives the steady ms a step
(from metrics.jsonl's per-call timestamps; the first interval holds the
start-up and is not counted), train rays/s, the peak device memory, the
validation PSNR at each checkpoint and the wall time; an eval line the
summary, the wall time and s per view.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from neo360_tpu_torch import cli  # noqa: E402
from neo360_tpu_torch.config import preset  # noqa: E402
from neo360_tpu_torch.data.fixtures import make_micro_scene, \
    make_multi_scene_root  # noqa: E402
from neo360_tpu_torch.train.checkpoints import CheckpointManager  # noqa

# JAX's numbers (TPU v5e, the same protocol) and the bar below them
JAX = {"vanilla": (37.09, 0.987), "mipnerf360": (37.05, 0.988),
       "pixelnerf": (31.31, 0.970)}
BAR_DB, BAR_SSIM = 2.0, 0.02
STEPS = {"vanilla": 30000, "mipnerf360": 20000, "pixelnerf": 20000}
# the phases' prefix -> the model
MODELS = {"vanilla": "vanilla", "mip": "mipnerf360", "pixelnerf": "pixelnerf"}
EXP = "accept"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("phase", choices=[f"{m}_{w}" for m in MODELS
                                     for w in ("train", "eval")])
    p.add_argument("--state", default="build/torch_accept_baselines")
    p.add_argument("--steps", type=int, default=None,
                   help="training steps (default: the protocol's)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def card(device):
    """The card's name and power limit as nvidia-smi gives them, or the
    device type when it is not a CUDA device."""
    if torch.device(device).type != "cuda":
        return torch.device(device).type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


class Run:
    """One model's settings: `overrides` apply to every config (the CPU
    test's tiny sizes); `wh` the scenes' resolution."""

    def __init__(self, args, model, overrides, wh=(320, 240)):
        self.args, self.model, self.overrides = args, model, overrides
        self.root = os.path.join(args.state, f"{model}_root")
        self.ckpt_dir = os.path.join(args.state, f"{model}_ckpts")
        self.steps = args.steps or STEPS[model]
        if not os.path.isdir(self.root):
            t0 = time.perf_counter()
            if model in ("vanilla", "mipnerf360"):
                make_micro_scene(self.root, wh=wh)
            else:
                make_multi_scene_root(self.root, 3, wh=wh, n_val=3)
            print(f"wrote {self.root} in {time.perf_counter() - t0:.1f} s",
                  flush=True)

    def cfg(self, **kw):
        per_call = 100
        if self.model == "vanilla":
            cfg = preset("vanilla", save_every_steps=max(1000,
                                                         self.steps // 4))
        elif self.model == "mipnerf360":
            cfg = preset("mipnerf360", chunk=4096,
                         save_every_steps=max(1, self.steps // 3))
            per_call = 500
        else:
            cfg = preset("pixelnerf", ray_batch_size=512, chunk=1024,
                         bf16=True, save_every_steps=max(1,
                                                         self.steps // 3))
        cfg = cfg.replace(root_dir=self.root, exp_name=EXP,
                          ckpt_dir=self.ckpt_dir, img_wh=(320, 240),
                          run_max_steps=self.steps, steps_per_call=per_call,
                          device=self.args.device)
        return cfg.replace(**self.overrides).replace(**kw)

    def record(self, line):
        line = dict(line, model=self.model, card=card(self.args.device))
        os.makedirs(self.args.state, exist_ok=True)
        with open(os.path.join(self.args.state, "accept.jsonl"), "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
        return line


def _records(cfg, since=0.0):
    with open(os.path.join(cfg.ckpt_dir, cfg.exp_name, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if r["time"] >= since]


def steady_ms_per_step(records):
    """Median ms per step between consecutive training-metric rows (the
    first row's interval, from the start of the run, is not one)."""
    rows = [r for r in records if "mse" in r]
    per = [(b["time"] - a["time"]) / (b["step"] - a["step"]) * 1e3
           for a, b in zip(rows, rows[1:]) if b["step"] > a["step"]]
    return statistics.median(per) if per else float("nan")


def phase_train(run):
    cfg = run.cfg()
    rays = (cfg.ray_batch_size if run.model == "pixelnerf"
            else cfg.batch_size)
    print(f"train {cfg.exp_type} to {cfg.run_max_steps} steps, {rays} "
          f"rays/step, save every {cfg.save_every_steps} -> "
          f"{cfg.ckpt_dir}", flush=True)
    if torch.device(cfg.device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    since, t0 = time.time(), time.perf_counter()
    state = cli.run_train(cfg)
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if torch.device(cfg.device).type == "cuda" else None)
    ms = steady_ms_per_step(_records(cfg, since))
    mgr = CheckpointManager(os.path.join(cfg.ckpt_dir, EXP, "checkpoints"))
    return run.record({
        "phase": "train", "steps": cfg.run_max_steps,
        "end_step": state.step, "newest_ckpt": mgr.latest_step(),
        "wall_s": wall, "steady_ms_per_step": ms,
        "steady_rays_s": rays / ms * 1e3, "peak_gib": peak,
        "val_psnr": {r["step"]: r["val_psnr"] for r in _records(cfg)
                     if "val_psnr" in r}})


def phase_eval(run):
    modes = ("batch", "running") if run.model == "pixelnerf" else ("batch",)
    jax_psnr, jax_ssim = JAX[run.model]
    out = {}
    for mode in modes:
        cfg = run.cfg(eval_mode="full_eval", eval_bn_mode=mode,
                      render_name=f"test_{mode}")
        t0 = time.perf_counter()
        summary = cli.run_eval(cfg)
        wall = time.perf_counter() - t0
        exp_dir = os.path.join(cfg.ckpt_dir, EXP)
        with open(os.path.join(exp_dir, "results.json")) as f:
            views = len(json.load(f)["psnr"]["views"])
        shutil.copy(os.path.join(exp_dir, "results.json"), os.path.join(
            run.args.state, f"results_{run.model}_{mode}.json"))
        out[mode] = dict(summary, wall_s=wall, views=views,
                         s_per_view=wall / views,
                         passes=bool(summary["psnr"] >= jax_psnr - BAR_DB
                                     and summary["ssim"]
                                     >= jax_ssim - BAR_SSIM))
    mgr = CheckpointManager(os.path.join(run.ckpt_dir, EXP, "checkpoints"))
    return run.record({"phase": "eval", "ckpt_step": mgr.latest_step(),
                       "jax": [jax_psnr, jax_ssim],
                       "bar": [jax_psnr - BAR_DB, jax_ssim - BAR_SSIM],
                       "modes": out})


def main(argv=None, wh=(320, 240), **overrides):
    args = parse(argv)
    prefix, what = args.phase.split("_")
    run = Run(args, MODELS[prefix], overrides, wh)
    return phase_train(run) if what == "train" else phase_eval(run)


if __name__ == "__main__":
    main()
