#!/usr/bin/env python3
"""Acceptance of the port's neo360_fast main path: train it through the
port's CLI and hold its quality to the JAX package's numbers from the same
protocol (scripts/accept_neo360.py, scripts/finetune_lpips_smoke.py and
scripts/optimize_speedup.py, ported).

    python3 scripts/torch_accept_neo360.py PHASE [--root DIR] [--state DIR]
        [--steps N[,N...]] [--scenes S] [--device cuda|cpu]

Phases, each through `neo360_tpu_torch.cli.run_train` / `run_eval` only,
each printing one JSON line (also appended to <state>/accept.jsonl):

- train: `neo360_fast` (stage trainer K=32, S=2, 500 rays a step) on the
  fixture root to each step count of --steps in turn (default 2112, then
  resumed to 8192), a validation render and checkpoint every 704 steps;
  each count is one run_train call.
- eval: `full_eval` of the newest training checkpoint on every test view,
  once per BatchNorm mode (batch, running); each mode's results.json is
  kept as <state>/results_<exp>_<step>_<mode>.json.
- optimize: `--is_optimize` (frozen SpatialEncoder with cached latents,
  BatchNorm on its running statistics, lr 5e-6, per-step trainer) for
  OPT_STEPS steps, warm-started (`--ckpt_path`) from the newest training
  checkpoint; then `full_eval` in both modes.
- finetune: `--finetune_lpips` for OPT_STEPS steps of one 30x30 patch
  (900 rays), warm-started the same way, with synthetic LPIPS weights
  written by this script from a seeded generator as a torch state dict
  (the repository holds no pretrained LPIPS weights).
- all: train and eval for each step count, then optimize and finetune.

Optimize and finetune check that every SpatialEncoder tensor and every
BatchNorm buffer of their last checkpoint equals the warm start's, bit for
bit, and record steady ms/step and rays/s from the run's metrics.jsonl
timestamps (one row per OPT_STEPS / 4 steps; the first interval, which
holds the start-up, is not counted).

The fixture root is written by the JAX package's
`neo360_tpu.data.fixtures.make_multi_scene_root(root, 4, wh=(320, 240))`
(the card's machine has no JAX): this script only reads it.
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

from neo360_tpu_torch import cli, weights  # noqa: E402
from neo360_tpu_torch.config import preset  # noqa: E402
from neo360_tpu_torch.data.nerds360_ae import PATCH_SIZE  # noqa: E402
from neo360_tpu_torch.train.checkpoints import CheckpointManager  # noqa

STEPS = (2112, 8192)
SAVE_EVERY = 704
OPT_STEPS = 256
LPIPS_SEED = 7
TRAIN_EXP = "accept"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("phase", choices=["train", "eval", "optimize",
                                     "finetune", "all"])
    p.add_argument("--root", default="build/accept_root")
    p.add_argument("--state", default="build/torch_accept")
    p.add_argument("--steps", default=",".join(map(str, STEPS)),
                   help="training step counts, in order (train, all)")
    p.add_argument("--scenes", type=int, default=4,
                   help="scenes the root must hold")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


class Run:
    """The phases' shared settings: `overrides` apply to every config
    (the CPU test's tiny sizes)."""

    def __init__(self, args, overrides):
        self.args, self.overrides = args, overrides
        self.ckpt_dir = os.path.join(args.state, "ckpts")
        scenes = sorted(f.name for f in os.scandir(args.root) if f.is_dir())
        if len(scenes) != args.scenes:
            raise ValueError(f"{args.root}: {len(scenes)} scenes, expected "
                             f"{args.scenes} (write the root with neo360_tpu."
                             f"data.fixtures.make_multi_scene_root)")

    def cfg(self, exp_name, **kw):
        cfg = preset("neo360_fast", root_dir=self.args.root,
                     exp_name=exp_name, ckpt_dir=self.ckpt_dir,
                     img_wh=(320, 240), save_every_steps=SAVE_EVERY,
                     val_every_steps=SAVE_EVERY, device=self.args.device)
        return cfg.replace(**self.overrides).replace(**kw)

    def newest(self, exp_name):
        """(step, path) of the newest checkpoint of `exp_name`."""
        mgr = CheckpointManager(os.path.join(self.ckpt_dir, exp_name,
                                             "checkpoints"))
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint of {exp_name} under "
                                    f"{self.ckpt_dir}")
        return step, mgr.path(step)

    def record(self, line):
        line = dict(line, card=card(self.args.device))
        os.makedirs(self.args.state, exist_ok=True)
        with open(os.path.join(self.args.state, "accept.jsonl"), "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
        return line


def card(device):
    """The card's name and power limit as nvidia-smi gives them, or the
    device type when it is not a CUDA device."""
    if torch.device(device).type != "cuda":
        return torch.device(device).type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _records(cfg, since=0.0):
    """The run's metrics.jsonl rows logged at or after time `since`."""
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


def phase_train(run, steps):
    cfg = run.cfg(TRAIN_EXP, run_max_steps=steps)
    print(f"train {cfg.exp_type} to {steps} steps: K={cfg.stage_k} "
          f"S={cfg.stage_scenes}, {cfg.ray_batch_size} rays/step, save every "
          f"{cfg.save_every_steps} -> {cfg.ckpt_dir}", flush=True)
    since, t0 = time.time(), time.perf_counter()
    state = cli.run_train(cfg)
    wall = time.perf_counter() - t0
    records = _records(cfg)
    ms = steady_ms_per_step(_records(cfg, since))
    return run.record({
        "phase": "train", "steps": steps, "end_step": state.step,
        "newest_ckpt": run.newest(TRAIN_EXP)[0], "wall_s": wall,
        "steady_ms_per_step": ms,
        "steady_rays_s": cfg.ray_batch_size / ms * 1e3,
        "val_psnr": {r["step"]: r["val_psnr"] for r in records
                     if "val_psnr" in r}})


def phase_eval(run, exp_name=TRAIN_EXP):
    step, _ = run.newest(exp_name)
    exp_dir = os.path.join(run.ckpt_dir, exp_name)
    modes = {}
    for mode in ("batch", "running"):
        cfg = run.cfg(exp_name, eval_mode="full_eval", eval_bn_mode=mode,
                      render_name=f"3views_{mode}_{step}")
        t0 = time.perf_counter()
        summary = cli.run_eval(cfg)
        modes[mode] = dict(summary, wall_s=time.perf_counter() - t0)
        shutil.copy(os.path.join(exp_dir, "results.json"), os.path.join(
            run.args.state, f"results_{exp_name}_{step}_{mode}.json"))
    with open(os.path.join(exp_dir, "results.json")) as f:
        views = len(json.load(f)["psnr"]["views"])
    return run.record({"phase": "eval", "exp": exp_name, "ckpt_step": step,
                       "views": views, "modes": modes})


def frozen_check(warm_path, path):
    """Compare the SpatialEncoder tensors and BatchNorm buffers of the
    checkpoint at `path` with the warm start's, bit for bit; returns
    (frozen tensors compared, other tensors that moved)."""
    load = lambda p: weights.from_checkpoint(torch.load(
        p, map_location="cpu", weights_only=True))
    warm, now = load(warm_path), load(path)
    frozen = [k for k in warm if "spatial_encoder" in k
              or k.endswith(("running_mean", "running_var"))]
    moved = [k for k in frozen if not torch.equal(warm[k], now[k])]
    if moved:
        raise AssertionError(f"frozen tensors moved: {moved[:10]} "
                             f"({len(moved)})")
    trained = sum(not torch.equal(warm[k], now[k]) for k in warm
                  if k not in frozen)
    if trained == 0:
        raise AssertionError("no trained tensor moved")
    return len(frozen), trained


def _tuning_run(run, exp_name, **flags):
    """A warm-started optimize or finetune run of OPT_STEPS steps; returns
    its JSON line's fields."""
    warm_step, warm_path = run.newest(TRAIN_EXP)
    per_call = max(1, OPT_STEPS // 4)
    cfg = run.cfg(exp_name, run_max_steps=OPT_STEPS, ckpt_path=warm_path,
                  steps_per_call=per_call, log_every_steps=per_call,
                  save_every_steps=OPT_STEPS, **flags)
    t0 = time.perf_counter()
    state = cli.run_train(cfg)
    wall = time.perf_counter() - t0
    records = _records(cfg)
    step, path = run.newest(exp_name)
    n_frozen, n_trained = frozen_check(warm_path, path)
    rays = PATCH_SIZE ** 2 if cfg.finetune_lpips else cfg.ray_batch_size
    ms = steady_ms_per_step(records)
    return {"warm_start_step": warm_step, "end_step": state.step,
            "wall_s": wall, "steady_ms_per_step": ms,
            "steady_rays_s": rays / ms * 1e3, "rays_per_step": rays,
            "frozen_tensors_bit_equal": n_frozen,
            "trained_tensors_moved": n_trained,
            "loss": [(r["step"], r["loss"]) for r in records if "loss" in r],
            "psnr": [(r["step"], r["psnr"]) for r in records if "psnr" in r]}


def phase_optimize(run):
    line = run.record(dict(phase="optimize",
                           **_tuning_run(run, "optimize", is_optimize=True)))
    phase_eval(run, "optimize")
    return line


def write_lpips_weights(path):
    """Synthetic LPIPS weights in the torch layout (torchvision VGG16
    `features.{i}` plus lpips `lin{i}.model.1.weight`) from a seeded
    generator."""
    from neo360_tpu_torch.nn.lpips import random_torch_state
    torch.save(random_torch_state(LPIPS_SEED), path)
    return path


def phase_finetune(run):
    os.makedirs(run.args.state, exist_ok=True)
    lpips = write_lpips_weights(os.path.join(run.args.state,
                                             "lpips_synthetic.pt"))
    return run.record(dict(phase="finetune", **_tuning_run(
        run, "finetune", finetune_lpips=True, lpips_weights=lpips)))


def main(argv=None, **overrides):
    args = parse(argv)
    run = Run(args, overrides)
    steps = [int(s) for s in args.steps.split(",")]
    if args.phase in ("train", "all"):
        for n in steps:
            phase_train(run, n)
            if args.phase == "all":
                phase_eval(run)
    if args.phase == "eval":
        phase_eval(run)
    if args.phase in ("optimize", "all"):
        phase_optimize(run)
    if args.phase in ("finetune", "all"):
        phase_finetune(run)


if __name__ == "__main__":
    main()
