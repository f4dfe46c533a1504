#!/usr/bin/env python3
"""Run the PyTorch / CUDA port (neo360_tpu_torch) on one NVIDIA GPU and
check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero, no result
line):

1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
2. build the hand-written kernels of neo360_tpu_torch/csrc with nvcc;
3. each kernel against its plain PyTorch version on seeded random inputs
   at the neo360_fast shapes, with both times (median of 20 runs);
4. the render slice at a small size in float32 on the card (kernels)
   against the same slice on the CPU (plain versions), TF32 off;
5. the main path: the neo360_fast model at full width (random seeded
   weights, bf16) encodes one in-memory 320x240 fixture scene once and
   renders 3 novel views through cli.make_render_fn + train.eval.evaluate,
   the code of `cli.run_eval`; every kernel must have launched.

The line before the last is {"kernels": [...]}, the last is
{"ok": true, "device": {...}}. Requires a CUDA device: it exits 2 without
one, or without the neo360_tpu_torch package beside it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
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
}


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


def _check(name, case, out, ref, kernel_fn, plain_fn, torch, results):
    from neo360_tpu_torch.ops import kernels
    outs = out if isinstance(out, (tuple, list)) else [out]
    refs = ref if isinstance(ref, (tuple, list)) else [ref]
    res = [kernels.compare(o, r) for o, r in zip(outs, refs)]
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
    checks = phase_kernels(torch)
    phase_small_reference(torch)
    from neo360_tpu_torch.config import preset
    launches = phase_main_path(torch, preset("neo360_fast", seed=SEED))

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
