#!/usr/bin/env python3
"""Run the PyTorch / CUDA port (neo360_tpu_torch) on one NVIDIA GPU and
check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero, no result
line):

1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
2. build the hand-written kernels of neo360_tpu_torch/csrc with nvcc;
3. each kernel, forward and backward, against its plain PyTorch version
   (the backward: autograd of the plain forward) on seeded random inputs
   at the neo360_fast shapes, with both times (median of 20 runs);
4. the render slice at a small size in float32 on the card (kernels)
   against the same slice on the CPU (plain versions), TF32 off;
5. one tiny float32 train stage (K=2, S=2, deterministic sampling) on the
   card against the same stage on the CPU, TF32 off: gradients, BatchNorm
   buffers and parameters;
6. the training main path: `cli.run_train` at full neo360_fast width
   (random seeded weights, bf16) on 3 in-memory 320x240 fixture scenes,
   2 stages of K=32 steps, S=2 scenes and 500 rays per step, then its
   validation render and checkpoint; every step's loss must be finite,
   every parameter and BatchNorm buffer must move (apart from the leaves
   whose gradient is zero by construction) and all six kernels must
   launch;
7. the serving main path: the same model encodes one in-memory 320x240
   fixture scene once and renders 3 novel views through cli.make_render_fn
   + train.eval.evaluate, the code of `cli.run_eval`; every forward kernel
   must launch.

The line before the last is {"kernels": [...]}, the last is
{"ok": true, "device": {...}}. Requires a CUDA device: it exits 2 without
one, or without the neo360_tpu_torch package beside it.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
TIMED_RUNS = 20

# (name, source, JAX function it replaces)
KERNELS = {
    "table_sample_fwd": ("neo360_tpu_torch/csrc/table_sample.cu",
                         "neo360_tpu/ops/interpolate.py:147"),
    "composite_nerfpp_fwd": ("neo360_tpu_torch/csrc/composite_nerfpp.cu",
                             "neo360_tpu/core/render.py:55"),
    "pillar_collapse_fwd": ("neo360_tpu_torch/csrc/pillar_collapse.cu",
                            "neo360_tpu/nn/triplane.py:268"),
    "table_sample_bwd": ("neo360_tpu_torch/csrc/table_sample_bwd.cu",
                         "neo360_tpu/ops/interpolate.py:221"),
    "composite_nerfpp_bwd": ("neo360_tpu_torch/csrc/composite_nerfpp_bwd.cu",
                             "neo360_tpu/core/render.py:55"),
    "pillar_collapse_bwd": ("neo360_tpu_torch/csrc/pillar_collapse_bwd.cu",
                            "neo360_tpu/nn/triplane.py:268"),
}
# leaves whose gradient is zero by construction: conv biases ahead of
# train-mode BatchNorm, and the pillar heads' biases (a softmax ignores a
# constant shift); rounding noise may still move them
ZERO_GRAD = re.compile(r"encoder\.(floorplan_(yz|xz|xy)\.conv[0-3]"
                       r"|tri_pillar\.out_(yz|xz|xy))\.bias$")


def counters():
    """Kernel name -> the wrapper that counts its launches."""
    from neo360_tpu_torch.core.render import composite_nerfpp, \
        composite_nerfpp_backward
    from neo360_tpu_torch.ops.interpolate import table_sample, \
        table_sample_backward
    from neo360_tpu_torch.ops.pillar import pillar_collapse, \
        pillar_collapse_backward
    return {"table_sample_fwd": table_sample,
            "composite_nerfpp_fwd": composite_nerfpp,
            "pillar_collapse_fwd": pillar_collapse,
            "table_sample_bwd": table_sample_backward,
            "composite_nerfpp_bwd": composite_nerfpp_backward,
            "pillar_collapse_bwd": pillar_collapse_backward}


def _median_ms(fn, torch) -> float:
    """Median device time of `fn` over TIMED_RUNS runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_card(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    return card


def phase_build():
    from neo360_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.library()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("[build]", line.strip())


def _check(name, case, out, ref, kernel_fn, plain_fn, torch, results,
           tols=None):
    """`tols`: compare() keywords, one dict for every output or a list of
    one per output."""
    from neo360_tpu_torch.ops import kernels
    outs = out if isinstance(out, (tuple, list)) else [out]
    refs = ref if isinstance(ref, (tuple, list)) else [ref]
    if not isinstance(tols, list):
        tols = [tols or {}] * len(outs)
    res = [kernels.compare(o, r, **t) for o, r, t in zip(outs, refs, tols)]
    max_abs = max(r["max_abs"] for r in res)
    max_rel = max(r["max_rel"] for r in res)
    ms = _median_ms(kernel_fn, torch)
    plain_ms = _median_ms(plain_fn, torch)
    ok = all(r["ok"] for r in res)
    print(f"[kernel] {name} {case}: max_abs {max_abs:.3e} max_rel "
          f"{max_rel:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {case} disagrees with its plain "
                             f"version: {res}")
    results.append((name, case, max_abs, ms, plain_ms))


def phase_kernels(torch):
    from neo360_tpu_torch.core.render import composite_nerfpp, \
        composite_nerfpp_reference
    from neo360_tpu_torch.ops.interpolate import table_sample, \
        table_sample_reference
    from neo360_tpu_torch.ops.pillar import pillar_collapse, \
        pillar_collapse_reference

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    results = []

    def uv(b, n, lim):
        u = (torch.rand(b, n, 2, device=dev, generator=g) * 2 - 1) * lim
        return u

    # Kernel A at the three neo360_fast call shapes (+ a flat view offset)
    hw = (120, 160)
    lat_table = torch.randn(3, 121, 161, 512, device=dev, generator=g).to(bf16)
    lift_uv = uv(3, 64 * 64 * 32, 1.5)
    lift_uv[0, :4] = torch.tensor([[1e30, 0.0], [-1e30, 0.0],
                                   [float("inf"), 0.0], [float("nan"), 0.0]])
    plane_uv = uv(3, 2 * 256 * 61, 1.2)
    local_table = torch.randn(6, 121, 161, 512, device=dev,
                              generator=g).to(bf16)
    local_uv = uv(6, 256 * 61, 1.2)
    cases = [
        ("lift zeros bf16->bf16", lat_table, lift_uv, "zeros", bf16, 0),
        ("plane zeros bf16->f32", lat_table, plane_uv, "zeros", f32, 0),
        ("local border bf16->f32", local_table, local_uv, "border", f32, 0),
        ("local border view_offset=3", local_table, local_uv[:3], "border",
         f32, 3),
    ]
    for case, table, u, mode, odt, off in cases:
        kernel = lambda: table_sample(table, u, hw, mode, odt, off)
        plain = lambda: table_sample_reference(table, u, hw, mode, odt, off)
        _check("table_sample_fwd", case, kernel(), plain(), kernel, plain,
               torch, results)

    # Kernel B: one 256-ray tile, prop level (65 points) and fine (61)
    for s in (65, 61):
        b = 256
        fg_t = torch.sort(torch.rand(b, s, device=dev, generator=g), -1).values
        bg_t = torch.sort(torch.rand(b, s, device=dev, generator=g), -1,
                          descending=True).values
        args = (torch.rand(b, s, 3, device=dev, generator=g),
                torch.rand(b, s, 1, device=dev, generator=g) * 10, fg_t,
                torch.rand(b, s, 3, device=dev, generator=g),
                torch.rand(b, s, 1, device=dev, generator=g) * 10, bg_t,
                torch.randn(b, 3, device=dev, generator=g),
                fg_t[:, -1:] + torch.rand(b, 1, device=dev, generator=g))
        keys = sorted(composite_nerfpp_reference(*args, False))
        kernel = lambda: composite_nerfpp(*args, False)
        plain = lambda: composite_nerfpp_reference(*args, False)
        out, ref = kernel(), plain()
        _check("composite_nerfpp_fwd", f"B=256 S={s}",
               [out[k] for k in keys], [ref[k] for k in keys],
               kernel, plain, torch, results)

    # Kernel C: the neo360_fast grid latent
    latent = torch.randn(3, 64, 64, 32, 512, device=dev, generator=g).to(bf16)
    logits = [(torch.randn(3, 64, 64, 32, device=dev, generator=g) * 3).to(
        bf16) for _ in range(3)]
    kernel = lambda: pillar_collapse(latent, *logits)
    plain = lambda: pillar_collapse_reference(latent, *logits)
    _check("pillar_collapse_fwd", "latent (3,64,64,32,512) bf16", kernel(),
           plain(), kernel, plain, torch, results)
    return results


def phase_backward_kernels(torch):
    """A', B' and C' at the shapes of the training main path, against
    autograd of the plain forward on the same inputs."""
    from neo360_tpu_torch.core.render import BACKWARD_TOL as B_TOL
    from neo360_tpu_torch.core.render import OUT_KEYS, \
        composite_nerfpp_backward, composite_nerfpp_reference
    from neo360_tpu_torch.ops.interpolate import BACKWARD_TOL as A_TOL
    from neo360_tpu_torch.ops.interpolate import table_sample_backward, \
        table_sample_reference
    from neo360_tpu_torch.ops.pillar import BACKWARD_TOL as C_TOL
    from neo360_tpu_torch.ops.pillar import pillar_collapse_backward, \
        pillar_collapse_reference

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf16, f32 = torch.bfloat16, torch.float32
    results = []

    def uv(b, n, lim):
        return (torch.rand(b, n, 2, device=dev, generator=g) * 2 - 1) * lim

    # A': the grid lift (bf16 cotangent), the flat tri-plane tables of two
    # scenes (scene 1: views 3-5) and the flat stacked local tables (scene
    # 1: views 6-11); per scene 250 rays x 61 fine points, fg + bg
    hw = (120, 160)
    lift_uv = uv(3, 64 * 64 * 32, 1.5)
    lift_uv[0, :4] = torch.tensor([[1e30, 0.0], [-1e30, 0.0],
                                   [float("inf"), 0.0], [float("nan"), 0.0]])
    cases = [("lift zeros bf16 cotangent", (3, 121, 161, 512), lift_uv,
              "zeros", bf16, 0),
             ("plane zeros f32 cotangent, view_offset=3", (6, 121, 161, 512),
              uv(3, 2 * 250 * 61, 1.2), "zeros", f32, 3),
             ("local border f32 cotangent, view_offset=6",
              (12, 121, 161, 512), uv(6, 250 * 61, 1.2), "border", f32, 6)]
    for case, shape, u, mode, gdt, off in cases:
        cot = torch.randn(u.shape[:2] + (128,), device=dev,
                          generator=g).to(gdt)
        # the plain version: autograd of the plain forward through an f32
        # table (the same values), rounded once to the table's bf16
        t32 = torch.zeros(shape, device=dev, requires_grad=True)
        fwd = table_sample_reference(t32, u, hw, mode, gdt, off)
        plain = lambda: torch.autograd.grad(fwd, t32, cot,
                                            retain_graph=True)[0].to(bf16)
        kernel = lambda: table_sample_backward(cot, u, shape, bf16, hw, mode,
                                               off)
        _check("table_sample_bwd", case, kernel(), plain(), kernel, plain,
               torch, results, A_TOL)
        del fwd, t32

    # B': one scene's 250 rays, proposal (65 points) and fine (61) levels;
    # the loss reads rgb and both weight histograms
    for s in (65, 61):
        b = 250
        fg_t = torch.sort(torch.rand(b, s, device=dev, generator=g), -1).values
        bg_t = torch.sort(torch.rand(b, s, device=dev, generator=g), -1,
                          descending=True).values
        args = (torch.rand(b, s, 3, device=dev, generator=g),
                torch.rand(b, s, 1, device=dev, generator=g) * 10, fg_t,
                torch.rand(b, s, 3, device=dev, generator=g),
                torch.rand(b, s, 1, device=dev, generator=g) * 10, bg_t,
                torch.randn(b, 3, device=dev, generator=g),
                fg_t[:, -1:] + torch.rand(b, 1, device=dev, generator=g))
        shapes = {"rgb": (b, 3), "fg_weights": (b, s), "bg_weights": (b, s)}
        grads = [torch.randn(shapes[k], device=dev, generator=g)
                 if k in shapes else None for k in OUT_KEYS]
        leaves = [a.detach().requires_grad_(i in (0, 1, 3, 4))
                  for i, a in enumerate(args)]
        out = composite_nerfpp_reference(*leaves, False)
        wrt = [leaves[i] for i in (0, 1, 3, 4)]
        outs = [out[k] for k in OUT_KEYS if k in shapes]
        gs = [gr for gr in grads if gr is not None]
        plain = lambda: torch.autograd.grad(outs, wrt, gs, retain_graph=True)
        kernel = lambda: composite_nerfpp_backward(args, grads, False)
        _check("composite_nerfpp_bwd", f"B=250 S={s}", list(kernel()),
               list(plain()), kernel, plain, torch, results, B_TOL)

    # C': the grid latent of one scene
    shape = (3, 64, 64, 32, 512)
    args = [torch.randn(shape, device=dev, generator=g).to(bf16)] + [
        (torch.randn(shape[:4], device=dev, generator=g) * 3).to(bf16)
        for _ in range(3)]
    cots = [torch.randn(s, device=dev, generator=g).to(bf16) for s in
            ((3, 64, 32, 512), (3, 64, 32, 512), (3, 64, 64, 512))]
    leaves = [a.detach().requires_grad_() for a in args]
    floors = pillar_collapse_reference(*leaves)
    plain = lambda: torch.autograd.grad(floors, leaves, cots,
                                        retain_graph=True)
    kernel = lambda: pillar_collapse_backward(args, cots)
    _check("pillar_collapse_bwd", "latent (3,64,64,32,512) bf16",
           list(kernel()), list(plain()), kernel, plain, torch, results,
           [C_TOL["latent"]] + [C_TOL["logit"][bf16]] * 3)
    return results


def phase_small_train(torch):
    """One tiny f32 stage (K=2, S=2, deterministic sampling) on the card
    (kernels) against the same stage on the CPU (plain versions).

    Tolerances: gradients, 2e-3 of the largest entry of each step's
    gradient (the float32 conditioning of this loss, measured against the
    JAX package in tests/test_torch_train.py); BatchNorm buffers, 1e-4
    relative plus 1e-5 of the largest; parameters, 2 x the summed Adam step
    sizes (a near-zero gradient entry whose sign differs moves Adam's first
    normalized step from +lr to -lr)."""
    import numpy as np

    from neo360_tpu_torch import cli
    from neo360_tpu_torch.data.fixtures import MemoryScenes
    from neo360_tpu_torch.models.neo360 import RAY_KEYS, SRC_KEYS, \
        make_scene_stage_fns
    from neo360_tpu_torch.ops import kernels
    from neo360_tpu_torch.train import loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _tiny_cfg(seed=SEED, stage_k=2, ray_batch_size=32)
    scenes = MemoryScenes(3, (40, 30), 3, split="train", ray_batch_size=32)
    stage = scenes.sample_train_stage(np.random.default_rng(SEED), 2, 2)
    runs = {}
    for dev in ("cpu", "cuda"):
        model = cli.build_model(cfg, dev).train()
        before = {k: v.detach().cpu().clone()
                  for k, v in model.state_dict().items()}
        grads = []

        def make_opt(params):
            opt = cli.build_optimizer(cfg, params)
            step = opt.step

            def recording(gr):
                grads.append([x.detach().cpu().clone() for x in gr])
                step(gr)
            opt.step = recording
            return opt

        state = loop.create_scene_stage_state(model, make_opt)
        enc_fn, loss_fn = make_scene_stage_fns(model, mixed=True,
                                               randomized=False)
        src = {k: torch.as_tensor(stage[k], device=dev) for k in SRC_KEYS}
        rays = {k: torch.as_tensor(stage[k], device=dev)
                for k in RAY_KEYS + ("target",)}
        loop.make_scene_stage_trainer(enc_fn, loss_fn)(state, src, rays,
                                                        None)
        runs[dev] = (before, {k: v.detach().cpu() for k, v in
                              model.state_dict().items()}, grads)
    (_, cpu_after, cpu_grads), (_, gpu_after, gpu_grads) = (runs["cpu"],
                                                            runs["cuda"])
    worst = 0.0
    for step_c, step_g in zip(cpu_grads, gpu_grads):    # ray, ray, encoder
        scale = max(float(x.abs().max()) for x in step_c)
        worst = max(worst, max(float((a - b).abs().max()) / scale
                               for a, b in zip(step_g, step_c)))
    bn = {k for k in cpu_after if k.endswith(("running_mean",
                                                "running_var"))}
    bn_res = [kernels.compare(gpu_after[k], cpu_after[k], rtol=1e-4,
                              atol_frac=1e-5) for k in sorted(bn)]
    sched = cli.build_optimizer(cfg, []).lr
    bound = 2 * (sched(0) + sched(1))
    param_err = max(float((gpu_after[k] - cpu_after[k]).abs().max())
                    for k in cpu_after if k not in bn)
    print(f"[small-train] K=2 S=2 f32 stage, card vs CPU: gradients max "
          f"{worst:.3e} of the largest entry (tolerance 2e-3), BatchNorm "
          f"buffers max rel {max(r['max_rel'] for r in bn_res):.3e} "
          f"({len(bn)} buffers), parameters max abs {param_err:.3e} "
          f"(bound {bound:.3e})")
    if not (worst <= 2e-3 and all(r["ok"] for r in bn_res)
            and param_err <= bound):
        raise AssertionError("the train stage on the card disagrees with "
                             "the CPU")


def phase_train_main_path(torch):
    """`cli.run_train` at full neo360_fast width: 2 stages of K=32, S=2,
    500 rays per step, on 3 in-memory 320x240 scenes, then its validation
    render and checkpoint."""
    import numpy as np

    from neo360_tpu_torch import cli
    from neo360_tpu_torch.config import preset
    from neo360_tpu_torch.data.fixtures import MemoryScenes
    from neo360_tpu_torch.models import neo360
    from neo360_tpu_torch.train import loop

    with tempfile.TemporaryDirectory() as tmp:
        cfg = preset("neo360_fast", seed=SEED, run_max_steps=64,
                     save_every_steps=64, steps_per_call=32,
                     log_every_steps=32, ckpt_dir=tmp, device="cuda")
        print(f"[train] {cfg.exp_type}: img_wh {cfg.img_wh}, bf16 "
              f"{cfg.bf16}, K={cfg.stage_k}, S={cfg.stage_scenes}, "
              f"{cfg.ray_batch_size} rays/step, 2 stages, grid "
              f"{cfg.grid_size or (64, 64, 32)}, lift {cfg.lift_dim}")
        datasets = tuple(MemoryScenes(3, cfg.img_wh, cfg.num_src_views,
                                      split=split,
                                      ray_batch_size=cfg.ray_batch_size)
                         for split in ("train", "val"))
        before = cli.build_model(cfg, "cpu").state_dict()
        losses, seconds = [], []
        plain_loss, plain_factory = (neo360.neo360_loss,
                                     loop.make_scene_stage_trainer)

        def recorded_loss(out, target):
            loss, l1 = plain_loss(out, target)
            losses.append(loss.detach())
            return loss, l1

        def timed_factory(*a, **kw):
            run = plain_factory(*a, **kw)

            def timed(*args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                metrics = run(*args)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t)
                return metrics
            return timed

        fns = counters()
        for fn in fns.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        neo360.neo360_loss, loop.make_scene_stage_trainer = (recorded_loss,
                                                             timed_factory)
        try:
            t0 = time.perf_counter()
            state = cli.run_train(cfg, datasets=datasets)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            neo360.neo360_loss, loop.make_scene_stage_trainer = (
                plain_loss, plain_factory)
        launches = {k: fn.launches for k, fn in fns.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(os.path.join(tmp, "exp", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        ckpts = sorted(os.listdir(os.path.join(tmp, "exp", "checkpoints")))

    values = torch.stack(losses).float().cpu().numpy()
    rays = cfg.ray_batch_size * cfg.stage_k
    for i, s in enumerate(seconds):
        print(f"[train] stage {i}: {s:.3f} s, {rays / s:.0f} train rays/s")
    print(f"[train] run_train wall {wall:.3f} s (model build, sampling, 2 "
          f"stages, validation render, checkpoint); peak device memory "
          f"{peak:.2f} GiB")
    print(f"[train] losses: {len(values)} (step x scene), first "
          f"{values[:2].mean():.4f}, last {values[-2:].mean():.4f}; "
          f"metrics.jsonl {records}; checkpoints {ckpts}")
    print(f"[train] launches on the training path: {launches}")
    if len(values) != 2 * cfg.stage_k * cfg.stage_scenes or \
            not np.isfinite(values).all():
        raise AssertionError(f"non-finite or missing losses: {values}")
    if state.step != 64 or "ckpt_00000064.pt" not in ckpts or not any(
            "val_psnr" in r and np.isfinite(r["val_psnr"]) for r in records):
        raise AssertionError("run_train did not validate and checkpoint "
                             "at step 64")
    after = {k: v.detach().cpu() for k, v in
             state.model.state_dict().items()}
    still = [k for k, v in before.items()
             if torch.equal(v, after[k]) and not ZERO_GRAD.search(k)]
    exempt = sorted(k for k in before if ZERO_GRAD.search(k))
    print(f"[train] {len(before)} parameter and buffer tensors; unchanged: "
          f"{still}; exempt (zero gradient by construction): {len(exempt)}")
    if still:
        raise AssertionError(f"tensors the training path did not move: "
                             f"{still}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the training path: "
                             f"{missing}")
    return launches, seconds, peak


def _tiny_cfg(**kw):
    from neo360_tpu_torch.config import preset
    return preset("neo360_fast", bf16=False, grid_size=(8, 8, 4),
                  encoder_width=64, lift_dim=32, num_prop_samples=8,
                  num_fine_samples=6, img_wh=(40, 30), **kw)


def phase_small_reference(torch):
    """The slice on the card against the same slice on the CPU."""
    from neo360_tpu_torch import cli
    from neo360_tpu_torch.data.fixtures import MemoryScenes
    from neo360_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _tiny_cfg(seed=SEED)
    sample = dict(MemoryScenes(1, (40, 30)).sample_test(0, 0), scene_key=0)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = cli.build_model(cfg, dev)
        outs[dev] = cli.make_render_fn(cfg, model, dev)(sample)
    for k in ("rgb", "depth"):
        res = kernels.compare(outs["cuda"][k].float().cpu(),
                              outs["cpu"][k].float())
        print(f"[small] 40x30 f32 slice, card vs CPU, {k}: max_abs "
              f"{res['max_abs']:.3e} (tolerance 1e-4 abs, TF32 off)")
        if not res["max_abs"] <= 1e-4:
            raise AssertionError(f"slice {k} on the card disagrees with the "
                                 f"CPU: {res}")


def phase_main_path(torch, cfg, dev="cuda"):
    """`cfg` (neo360_fast at full width): one encode, 3 rendered views."""
    import numpy as np

    from neo360_tpu_torch import cli
    from neo360_tpu_torch.core.render import composite_nerfpp
    from neo360_tpu_torch.data.fixtures import MemoryScenes
    from neo360_tpu_torch.ops.interpolate import table_sample
    from neo360_tpu_torch.ops.pillar import pillar_collapse
    from neo360_tpu_torch.train.eval import evaluate

    print(f"[main] {cfg.exp_type}: img_wh {cfg.img_wh}, bf16 {cfg.bf16}, lift "
          f"{cfg.lift_dim}, grid {cfg.grid_size or (64, 64, 32)}, fine samples "
          f"{cfg.num_fine_samples}, chunk {cfg.chunk}, BN {cfg.eval_bn_mode}")
    scenes = MemoryScenes(1, cfg.img_wh, cfg.num_src_views)
    samples = [dict(scenes.sample_test(0, d), scene_key=0) for d in range(3)]
    model = cli.build_model(cfg, dev)
    print("WARNING: no checkpoint; evaluating a seeded random init")

    # the encode alone, timed (also warms cuDNN up); not counted
    src = {k: torch.as_tensor(samples[0][k], device=dev) for k in cli.SRC_KEYS}
    with torch.inference_mode():
        model.encode(*(src[k] for k in cli.SRC_KEYS), True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.encode(*(src[k] for k in cli.SRC_KEYS), True)
        torch.cuda.synchronize()
    print(f"[main] encode {time.perf_counter() - t0:.3f} s")

    counted = {"table_sample_fwd": table_sample,
               "composite_nerfpp_fwd": composite_nerfpp,
               "pillar_collapse_fwd": pillar_collapse}
    for fn in counted.values():
        fn.launches = 0
    render_fn = cli.make_render_fn(cfg, model, dev)
    w, h = cfg.img_wh

    def timed(sample):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = render_fn(sample)
        torch.cuda.synchronize()
        timed.seconds.append(time.perf_counter() - t)
        for k, v in out.items():
            if v.shape[0] != w * h or not bool(torch.isfinite(v).all()):
                raise AssertionError(f"output {k}: shape {tuple(v.shape)} or "
                                     f"non-finite values")
        return out

    timed.seconds = []
    views = list(evaluate(timed, samples, cfg.img_wh))
    launches = {k: fn.launches for k, fn in counted.items()}
    for i, (v, s) in enumerate(zip(views, timed.seconds)):
        what = "encode + render" if i == 0 else "render"
        print(f"[main] view {i}: {what} {s:.3f} s ({w * h} rays), PSNR "
              f"{v.psnr:.3f} SSIM {v.ssim:.4f}")
        if not (np.isfinite(v.psnr) and np.isfinite(v.ssim)
                and np.isfinite(v.rgb).all() and np.isfinite(v.depth).all()):
            raise AssertionError(f"view {i}: non-finite output or metrics")
    print(f"[main] render s/view (views 1-2, encode cached): "
          f"{statistics.mean(timed.seconds[1:]):.3f}")
    print(f"[main] launches on the main path: {launches}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: "
                             f"{missing}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import neo360_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the neo360_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2

    phase_card(torch)
    phase_build()
    checks = phase_kernels(torch) + phase_backward_kernels(torch)
    phase_small_reference(torch)
    phase_small_train(torch)
    launches, _, _ = phase_train_main_path(torch)
    from neo360_tpu_torch.config import preset
    phase_main_path(torch, preset("neo360_fast", seed=SEED))

    entries = []
    for name, (source, replaces) in KERNELS.items():
        rows = [r for r in checks if r[0] == name]
        heaviest = max(rows, key=lambda r: r[4])
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": max(r[2] for r in rows),
                        "ms": heaviest[3], "plain_ms": heaviest[4]})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
