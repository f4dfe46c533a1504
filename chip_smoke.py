#!/usr/bin/env python3
"""Run the PyTorch / CUDA port (neo360_tpu_torch) on one NVIDIA GPU and
check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero, no result
line):

1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
2. build the hand-written kernels of neo360_tpu_torch/csrc with nvcc;
3. each kernel, forward and backward, against its plain PyTorch version
   (the backward: autograd of the plain forward, or its index_add_ plain
   version under the accumulate contract) on seeded random inputs at the
   neo360_fast and neo360 shapes (kernel C also at a ragged Z = 48, and
   twice, for the same bits; kernel A at the neo360 lift also at the
   grid's own uv; the fused tri-plane and local gathers at a level's
   points of a fixture view, in bf16 and f32 tables, with flat
   two-scene view offsets and non-finite points), with both times
   (median of 20 runs), the
   kernel's bound (bytes over the card's memory rate or operations over
   its f32 rate, whichever is larger; `bound`) and its share of it, and
   for the corner-table kernels the time of `F.grid_sample` (forward, and
   the autograd of it with respect to the map) on the same points;
4. the render slice at a small size in float32 on the card (kernels)
   against the same slice on the CPU (plain versions), TF32 off;
5. one tiny float32 neo360_fast train stage (K=2, S=2) and one tiny
   float32 neo360 per-step step (grid (8, 8, 40)), deterministic sampling,
   on the card against the same on the CPU, TF32 off: gradients,
   BatchNorm buffers, and the stage's parameters or the step's loss;
6. the neo360_fast training main path: `cli.run_train` at full width
   (random seeded weights, bf16) on 3 in-memory 320x240 fixture scenes,
   3 stages of K=32 steps, S=2 scenes and 500 rays per step (the third
   under `torch.profiler`, whose top device ops are printed), then its
   validation render and checkpoint; every step's loss must be finite,
   every parameter and BatchNorm buffer must move (apart from the leaves
   whose gradient is zero by construction), all eight kernels must
   launch, and every stage must launch kernel A (the lift), C and C' S
   times, the fused tri-plane and local gathers S x K times each, kernel
   A' once per scene under the dense contract (the grid lift) and 4 x S x
   K times under the accumulate contract (the tri-plane and local
   tables), and kernel B' 2 x S x K times (both levels of every
   scene-step);
7. the neo360_fast serving main path: the same model encodes one
   in-memory 320x240 fixture scene once and renders 3 novel views through
   cli.make_render_fn + train.eval.evaluate, the code of `cli.run_eval`;
   every forward kernel must launch: A and C once (the encode, with the
   first view), the fused gathers once per 256-ray tile, B twice. One
   more render of a view runs under `torch.profiler`;
8. the neo360 main path (`phase_neo360_main_path`): `cli.run_train` at
   full width with the per-step trainer (float32, 64^3 grid, 512-channel
   lift, 128 + 256 samples, the encoder's recompute), 10 steps of 500
   rays, each launching exactly the kernels `_neo360_step_launches` says;
   its validation render and checkpoint; 2 rendered views and 16 profiled
   tiles; one step without the recompute for its time and peak memory;
9. the optimize and LPIPS-finetune modes (`phase_optimize_finetune`):
   `cli.run_train` at full neo360_fast width, warm-started from phase 6's
   checkpoint, OPT_STEPS optimize steps (the frozen SpatialEncoder's
   latents cached once per scene) and FT_STEPS finetune steps (synthetic
   LPIPS weights, 30x30 patches) on 3 in-memory scenes; every step
   launches exactly the kernels `_optimize_step_launches` says, every loss
   is finite, the SpatialEncoder's tensors and every BatchNorm buffer keep
   the warm start's bits and the trained tensors move.

Each kernel's launches per training stage or step and per rendered view
follow the last phase. The line before the last is {"kernels": [...]}
(the eight kernels; launches: the sum over the five main paths, each
counted from 0), the
last is {"ok": true, "device": {...}}. Requires a CUDA device: it exits 2
without one, or without the neo360_tpu_torch package beside it.
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
# the bound's peaks: one H100 SXM (NVIDIA's datasheet figures): HBM3 bytes
# per second, and float32 operations per second outside the tensor cores
# (every kernel here computes in float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# (name, source, JAX function it replaces)
KERNELS = {
    "table_sample_fwd": ("neo360_tpu_torch/csrc/table_sample.cu",
                         "neo360_tpu/ops/interpolate.py:147"),
    "triplane_sample_fwd": ("neo360_tpu_torch/csrc/triplane_sample.cu",
                            "neo360_tpu/nn/triplane.py:328"),
    "local_sample_fwd": ("neo360_tpu_torch/csrc/local_sample.cu",
                         "neo360_tpu/models/neo360.py:276"),
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
    """Counter name -> the wrapper that counts its launches: one per
    kernel, and kernel A' under each of its two contracts (dense and
    accumulate)."""
    from neo360_tpu_torch.core.render import composite_nerfpp, \
        composite_nerfpp_backward
    from neo360_tpu_torch.ops.interpolate import local_sample, \
        table_sample, table_sample_accumulate, table_sample_backward, \
        triplane_sample
    from neo360_tpu_torch.ops.pillar import pillar_collapse, \
        pillar_collapse_backward
    return {"table_sample_fwd": table_sample,
            "triplane_sample_fwd": triplane_sample,
            "local_sample_fwd": local_sample,
            "composite_nerfpp_fwd": composite_nerfpp,
            "pillar_collapse_fwd": pillar_collapse,
            "table_sample_bwd": table_sample_backward,
            "table_sample_bwd_acc": table_sample_accumulate,
            "composite_nerfpp_bwd": composite_nerfpp_backward,
            "pillar_collapse_bwd": pillar_collapse_backward}


def _read(fns) -> dict:
    """Counter name -> launches so far."""
    return {k: fn.launches for k, fn in fns.items()}


def _by_kernel(counts) -> dict:
    """Counter values summed per kernel (A' = dense + accumulate)."""
    out = {k: v for k, v in counts.items() if k != "table_sample_bwd_acc"}
    out["table_sample_bwd"] += counts["table_sample_bwd_acc"]
    return out


def _bound(nbytes: float, ops: float):
    """(least ms the card could take, "bytes" or "operations")."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def _share(bound_ms: float, ms: float) -> str:
    return f"{bound_ms / ms:.1%}" if ms > 0 else "not measured"


def _rows_read(table_shape, uv, hw, mode, view_offset) -> int:
    """Distinct corner-table rows that the points read (and kernel A'
    writes): finite points inside the table's reach."""
    import torch

    from neo360_tpu_torch.ops.interpolate import _corners
    idx, wts = _corners(uv, hw, mode, table_shape[0], view_offset)
    live = torch.isfinite(uv).all(-1).reshape(-1) & (wts.abs().sum(-1) > 0)
    return int(torch.unique(idx[live]).numel())


# the port's kernels (csrc/*.cu) as the profiler names them
PORT_KERNEL = re.compile(r"::(table_sample|triplane_sample|local_sample"
                         r"|table_scatter|round_to_bf16"
                         r"|composite_nerfpp(_bwd)?|pillar_(collapse|weights"
                         r"|softmax|dlogit|dlatent))_kernel\b")


def _profile(torch, fn, label: str, top: int = 15):
    """Run `fn` once under torch.profiler and print the device's busy
    share, the top `top` kernels and ops by device time, and every kernel
    of the port."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels_, ops = [], []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = e.self_cuda_time_total
        if dev <= 0:
            continue
        on_device = str(e.device_type).endswith("CUDA")
        (kernels_ if on_device else ops).append((dev / 1e3, e.count, e.key))
    busy = sum(r[0] for r in kernels_)
    launches = sum(r[1] for r in kernels_)
    print(f"[profile] {label}: wall {wall:.3f} s under the profiler, device "
          f"time {busy / 1e3:.3f} s in {launches} kernels, busy "
          f"{busy / 1e3 / wall:.1%}")
    if not kernels_:
        print(f"[profile] {label}: the profiler recorded no device time "
              f"(not measured)")
    port = [r for r in kernels_ if PORT_KERNEL.search(r[2])]
    for what, rows in (("kernel", kernels_), ("op", ops),
                       ("port kernel", port)):
        for ms, n, key in sorted(rows, reverse=True)[:top]:
            print(f"[profile] {label} {what}: {ms:9.3f} ms "
                  f"{ms / max(busy, 1e-9):6.1%} x{n:<6d} "
                  f"{ms / n * 1e3:8.1f} us/call {key[:90]}")


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


def _device_ms(torch, fn) -> dict:
    """{kernel name: device ms per call} of `fn` over TIMED_RUNS calls
    under torch.profiler, after a warm-up (memsets included). For a
    kernel of a few microseconds a CUDA-event time around one call
    measures the caller's host work; this does not."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TIMED_RUNS):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / TIMED_RUNS
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0}


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
           tols=None, nbytes=0.0, ops=0.0, library_fn=None, main=False):
    """Hold a kernel's output against its plain version's, time both (and
    `library_fn`, one PyTorch call computing the same function, if any),
    and give the kernel's bound for `nbytes` moved and `ops` done. `tols`:
    compare() keywords, one dict for every output or a list of one per
    output. `main`: the case the {"kernels": ...} line reports."""
    from neo360_tpu_torch.ops import kernels
    outs = out if isinstance(out, (tuple, list)) else [out]
    refs = ref if isinstance(ref, (tuple, list)) else [ref]
    if not isinstance(tols, list):
        tols = [tols or {}] * len(outs)
    res = [kernels.compare(o, r, **t) for o, r, t in zip(outs, refs, tols)]
    max_abs = max(r["max_abs"] for r in res)
    max_rel = max(r["max_rel"] for r in res)
    ms = _median_ms(kernel_fn, torch)
    device_ms = sum(_device_ms(torch, kernel_fn).values())
    plain_ms = _median_ms(plain_fn, torch)
    library_ms = _median_ms(library_fn, torch) if library_fn else None
    bound_ms, bound_by = _bound(nbytes, ops)
    ok = all(r["ok"] for r in res)
    lib = f"{library_ms:.4f} ms" if library_ms is not None else "none"
    print(f"[kernel] {name} {case}: max_abs {max_abs:.3e} max_rel "
          f"{max_rel:.3e} kernel {ms:.4f} ms (device {device_ms:.4f} ms) "
          f"plain {plain_ms:.4f} ms library {lib} bound {bound_ms:.4f} ms "
          f"({bound_by}, {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} Gop) share "
          f"{bound_ms / ms:.1%} (device {_share(bound_ms, device_ms)}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {case} disagrees with its plain "
                             f"version: {res}")
    results.append({"name": name, "case": case, "max_abs": max_abs,
                    "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "main": main})


def _grid_sample_fns(torch, c, dtype, uv, hw, mode, cot=None):
    """`F.grid_sample(align_corners=True)` on an NCHW map of `dtype` and C
    channels, over the views the points read, at the same points: the
    forward, or (given the output cotangent `cot`) autograd of it with
    respect to the map. A yardstick only: the port never calls it. Its
    gradient is the map's, not the corner table's, and it takes the grid
    in the map's type (bf16 uv for a bf16 map)."""
    import torch.nn.functional as F
    fmap = torch.randn(uv.shape[0], c, *hw, device=uv.device).to(dtype)
    grid = uv[:, :, None, :].to(dtype)
    if cot is None:
        return lambda: F.grid_sample(fmap, grid, "bilinear", mode,
                                     align_corners=True)
    fmap.requires_grad_()
    out = F.grid_sample(fmap, grid, "bilinear", mode, align_corners=True)
    g = cot.permute(0, 2, 1)[..., None].to(out.dtype).contiguous()
    return lambda: torch.autograd.grad(out, fmap, g, retain_graph=True)


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
        b, n = u.shape[:2]
        c4 = table.shape[-1]
        rows = _rows_read(table.shape, u, hw, mode, off)
        out_bytes = torch.tensor([], dtype=odt).element_size()
        nbytes = (u.numel() * 4 + rows * c4 * table.element_size()
                  + b * n * c4 // 4 * out_bytes)
        _check("table_sample_fwd", case, kernel(), plain(), kernel, plain,
               torch, results, nbytes=nbytes, ops=2.0 * b * n * c4,
               library_fn=_grid_sample_fns(torch, c4 // 4, table.dtype, u,
                                           hw, mode),
               main=case.startswith("lift"))

    # Kernel B: one 256-ray tile, prop level (65 points) and fine (61)
    for s in (65, 61):
        b = 256
        args = _composite_args(torch, g, b, s)
        keys = sorted(composite_nerfpp_reference(*args, False))
        kernel = lambda: composite_nerfpp(*args, False)
        plain = lambda: composite_nerfpp_reference(*args, False)
        out, ref = kernel(), plain()
        # per sample: rgb, sigma, t read, one weight written, per branch;
        # per ray: dirs, far read, 14 sums written
        _check("composite_nerfpp_fwd", f"B=256 S={s}",
               [out[k] for k in keys], [ref[k] for k in keys],
               kernel, plain, torch, results,
               nbytes=4.0 * b * (2 * 6 * s + 4 + 14), ops=2 * 20.0 * b * s,
               main=s == 61)

    # Kernel A at the neo360 preset's f32 grid lift: the 512-channel pixel
    # latent table at every cell of the 64^3 grid of 3 views, at uniform
    # uv and at the grid's own uv (a fixture scene's source views)
    table = torch.randn(3, 121, 161, 2048, device=dev, generator=g)
    view = _fixture_view(torch)
    for what, u in (("uniform uv", uv(3, 64 ** 3, 1.5)),
                    ("grid uv", _lift_uv(torch, view, (64, 64, 64)))):
        kernel = lambda: table_sample(table, u, hw, "zeros", f32)
        plain = lambda: table_sample_reference(table, u, hw, "zeros", f32)
        rows = _rows_read(table.shape, u, hw, "zeros", 0)
        _check("table_sample_fwd",
               f"neo360 lift zeros f32->f32, 3 x 64^3 pts, {what}",
               kernel(), plain(), kernel, plain, torch, results,
               nbytes=(u.numel() * 4 + rows * 2048 * 4
                       + u.shape[1] * 3 * 512 * 4),
               ops=2.0 * 3 * u.shape[1] * 2048,
               library_fn=_grid_sample_fns(torch, 512, f32, u, hw, "zeros"))
    del table, u

    results += _check_fused(torch, g, view)

    # Kernel B at the neo360 tiles: a 256-ray render tile of the merged
    # fine level (385 points) and a 500-ray train step's coarse level (129)
    for b, s in ((256, 385), (500, 129)):
        args = _composite_args(torch, g, b, s)
        keys = sorted(composite_nerfpp_reference(*args, False))
        kernel = lambda: composite_nerfpp(*args, False)
        plain = lambda: composite_nerfpp_reference(*args, False)
        out, ref = kernel(), plain()
        _check("composite_nerfpp_fwd", f"neo360 B={b} S={s}",
               [out[k] for k in keys], [ref[k] for k in keys],
               kernel, plain, torch, results,
               nbytes=4.0 * b * (2 * 6 * s + 4 + 14), ops=2 * 20.0 * b * s)

    # Kernel C: the neo360_fast grid latent (bf16, Z = 32), the neo360
    # preset's (f32, Z = 64; and in bf16), and a ragged Z = 48; two calls
    # must give the same bits
    for dt, shape, main in ((bf16, (3, 64, 64, 32, 512), True),
                            (f32, (3, 64, 64, 64, 512), False),
                            (bf16, (3, 64, 64, 64, 512), False),
                            (f32, (3, 64, 64, 48, 512), False),
                            (bf16, (3, 64, 64, 48, 512), False)):
        latent = torch.randn(shape, device=dev, generator=g).to(dt)
        logits = [(torch.randn(shape[:4], device=dev, generator=g) * 3).to(
            dt) for _ in range(3)]
        kernel = lambda: pillar_collapse(latent, *logits)
        plain = lambda: pillar_collapse_reference(latent, *logits)
        nv, x, y, z, c = shape
        cells = nv * x * y * z
        floor_elems = nv * (y * z + x * z + x * y) * c
        out = kernel()
        same = all(torch.equal(a, b) for a, b in zip(out, kernel()))
        name = {bf16: "bf16", f32: "f32"}[dt]
        print(f"[kernel] pillar_collapse_fwd {shape} {name}: two calls give "
              f"the same bits: {same}")
        if not same:
            raise AssertionError(f"kernel C is not deterministic at {shape} "
                                 f"{name}")
        # the latent and 3 logits read, 3 floors written; per cell and
        # floor a softmax term (~4 ops) and a C-wide multiply-add
        _check("pillar_collapse_fwd", f"latent {shape} {name}", out,
               plain(), kernel, plain, torch, results,
               nbytes=latent.element_size() * (latent.numel() + 3 * cells
                                               + floor_elems),
               ops=3.0 * (latent.numel() * 2 + cells * 4), main=main)
        del latent, logits, out
    return results


def _check_fused(torch, g, view):
    """The fused tri-plane and local gathers against their plain versions
    at a level's points (`_level_cam`): neo360_fast (bf16 tables) at a
    256-ray render tile of 61 points a branch and at scene 1 of a stage
    step (flat two-scene tables: view offsets 3 and 6), neo360 (f32) at a
    256-ray render tile and a 500-ray training step of its fine (385) and
    coarse (129) level; some points are non-finite, on a camera plane or
    behind the cameras."""
    from neo360_tpu_torch.nn.resnet import latent_scaling
    from neo360_tpu_torch.ops.interpolate import FUSED_TOL, local_sample, \
        local_sample_reference, local_uv, triplane_sample, \
        triplane_sample_reference, triplane_uvs

    dev = g.device
    bf16, f32 = torch.bfloat16, torch.float32
    hw = (120, 160)
    focal, c = view["src_focal"], view["src_c"]
    scale = (latent_scaling(hw) / torch.tensor([320.0, 240.0])).tolist()
    inf, nan = float("inf"), float("nan")
    odd = torch.tensor([[inf, 0.2, -1.0], [0.1, -inf, -0.5], [0.1, 0.2, 0.0],
                        [0.3, -0.2, 0.7], [1e30, 0.1, -1.0]], device=dev)
    results = []
    for what, dt, n_rays, s, scene, main in (
            ("neo360_fast tile", bf16, 256, 61, 0, True),
            ("neo360_fast stage scene 1", bf16, 250, 61, 1, False),
            ("neo360 fine tile", f32, 256, 385, 0, False),
            ("neo360 coarse tile", f32, 256, 129, 0, False),
            ("neo360 fine step", f32, 500, 385, 0, False),
            ("neo360 coarse step", f32, 500, 129, 0, False)):
        cam = _level_cam(torch, view, n_rays, s)
        half = cam.shape[1] // 2
        cam[0, :5] = odd
        cam[1, half:half + 5] = odd
        tri_cam = cam.clone()
        tri_cam[2, :2] = nan       # zeros mode: NaN samples zeros
        nv, n = cam.shape[:2]
        name = {bf16: "bf16", f32: "f32"}[dt]
        case = f"{what}, {n_rays} rays x {s}, {name} tables"
        planes = [torch.randn(3 * (1 + scene), 121, 161, 512, device=dev,
                              generator=g).to(dt) for _ in range(3)]
        kernel = lambda: triplane_sample(planes, tri_cam, hw, 3 * scene)
        plain = lambda: triplane_sample_reference(planes, tri_cam, hw,
                                                  3 * scene)
        uvs = triplane_uvs(tri_cam)
        rows = sum(_rows_read(t.shape, u, hw, "zeros", 3 * scene)
                   for t, u in zip(planes, uvs))
        # cam read once, the rows touched read once, the f32 sum written
        _check("triplane_sample_fwd", case, kernel(), plain(), kernel, plain,
               torch, results, FUSED_TOL,
               nbytes=(cam.numel() * 4 + rows * 512 * planes[0].element_size()
                       + nv * n * 128 * 4),
               ops=3 * 2.0 * nv * n * 512 + 2.0 * nv * n * 128,
               library_fn=_grid_sample_fns(torch, 128, dt, torch.cat(uvs, 0),
                                           hw, "zeros"),
               main=main)
        table = torch.randn(6 * (1 + scene), 121, 161, 512, device=dev,
                            generator=g).to(dt)
        kernel = lambda: local_sample(table, cam, focal, c, scale, hw,
                                      6 * scene)
        plain = lambda: local_sample_reference(table, cam, focal, c, scale,
                                               hw, 6 * scene)
        u = local_uv(cam, focal, c, scale)
        rows = _rows_read(table.shape, u, hw, "border", 6 * scene)
        # cam read once, the rows touched read once, the output written;
        # per point ~8 operations of projection and a 4C-wide fold
        _check("local_sample_fwd", case, kernel(), plain(), kernel, plain,
               torch, results, FUSED_TOL,
               nbytes=(cam.numel() * 4 + rows * 512 * table.element_size()
                       + nv * n * 128 * 4),
               ops=2.0 * nv * n * 512 + 8.0 * nv * n,
               library_fn=_grid_sample_fns(torch, 128, dt, u, hw, "border"),
               main=main)
        del planes, table, cam, tri_cam, uvs, u
    return results


def _composite_args(torch, g, b, s):
    """Seeded inputs of kernel B / B' for `b` rays of `s` points: fg t
    ascending, bg t descending, far past the last fg t."""
    dev = g.device
    fg_t = torch.sort(torch.rand(b, s, device=dev, generator=g), -1).values
    bg_t = torch.sort(torch.rand(b, s, device=dev, generator=g), -1,
                      descending=True).values
    return (torch.rand(b, s, 3, device=dev, generator=g),
            torch.rand(b, s, 1, device=dev, generator=g) * 10, fg_t,
            torch.rand(b, s, 3, device=dev, generator=g),
            torch.rand(b, s, 1, device=dev, generator=g) * 10, bg_t,
            torch.randn(b, 3, device=dev, generator=g),
            fg_t[:, -1:] + torch.rand(b, 1, device=dev, generator=g))


def _ray_uv(torch, g, b, n_rays, s, lim=1.2, reach=0.5):
    """uv of `s` sorted samples along each of `n_rays` segments per view
    (start uniform in [-lim, lim]^2, extent normal with deviation `reach`):
    consecutive points of a ray often read one corner row, as along the
    path's rays."""
    dev = g.device
    start = (torch.rand(b, n_rays, 1, 2, device=dev, generator=g) * 2
             - 1) * lim
    step = torch.randn(b, n_rays, 1, 2, device=dev, generator=g) * reach
    t = torch.sort(torch.rand(b, n_rays, s, 1, device=dev, generator=g),
                   2).values
    return (start + t * step).reshape(b, n_rays * s, 2)


def _fixture_view(torch):
    """One 320x240 fixture view of a seeded in-memory scene, as tensors on
    the card: its rays and its 3 source views' poses, focal and centre."""
    from neo360_tpu_torch.data.fixtures import MemoryScenes
    sample = MemoryScenes(1, (320, 240), 3).sample_test(0, 0)
    return {k: torch.as_tensor(v, device="cuda") for k, v in sample.items()
            if k in ("rays_o", "rays_d", "src_poses", "src_focal", "src_c")}


def _level_points(torch, view, n_rays, s):
    """World points (fg, bg), each (n_rays, s, 3), of a conditioned level:
    `s` evenly spaced fg points inside the unit sphere and `s` bg points
    beyond it on each of `n_rays` consecutive rays of the view's middle
    rows (the level's [fg | bg] halves)."""
    from neo360_tpu_torch.core import sampling, spherical
    start = 120 * 320
    rays_o = view["rays_o"][start:start + n_rays]
    rays_d = view["rays_d"][start:start + n_rays]
    near = torch.full_like(rays_o[..., :1], 1e-4)
    far = torch.clamp(spherical.intersect_sphere(rays_o, rays_d), min=2e-4)
    _, fg = sampling.sample_along_rays_nerfpp(rays_o, rays_d, s - 1, near,
                                              far, in_sphere=True)
    _, _, bg = sampling.sample_along_rays_nerfpp(
        rays_o, rays_d, s - 1, near, far, in_sphere=False,
        far_uncontracted=3.0)
    return fg, bg


def _level_cam(torch, view, n_rays, s):
    """Camera points (3, 2 * n_rays * s, 3) of `_level_points`, [fg | bg],
    seen from the view's 3 source views."""
    from neo360_tpu_torch.core import geometry
    fg, bg = _level_points(torch, view, n_rays, s)
    return geometry.world2camera(torch.cat([fg, bg], 0).reshape(1, -1, 3),
                                 view["src_poses"], ns=3)


def _lift_uv(torch, view, grid):
    """uv (3, X*Y*Z, 2) of the grid lift: the world grid of `grid` cells
    projected into the 3 source views' 120x160 latent, as
    GridEncoder._grid computes it."""
    from neo360_tpu_torch.core import geometry
    from neo360_tpu_torch.nn.resnet import latent_scaling
    dev = view["src_poses"].device
    world = geometry.get_world_grid([[-1.0, 1.0], [-1.0, 1.0], [0.0, 1.0]],
                                    list(grid), device=dev)
    cam = geometry.world2camera(geometry.repeat_interleave(world, 3),
                                view["src_poses"])
    focal = view["src_focal"]
    uv = geometry.projection(cam, torch.stack([focal[0], -focal[0]])[None],
                             view["src_c"][:1], 3)
    scale = latent_scaling((120, 160), dev) / torch.tensor(
        [320.0, 240.0], device=dev)
    return uv * scale - 1.0


def phase_backward_kernels(torch):
    """A', B' and C' at the shapes of the training main path, against
    autograd of the plain forward on the same inputs (A' under the
    accumulate contract: against its index_add_ plain version)."""
    from neo360_tpu_torch.core.render import BACKWARD_TOL as B_TOL
    from neo360_tpu_torch.core.render import OUT_KEYS, \
        composite_nerfpp_backward, composite_nerfpp_reference
    from neo360_tpu_torch.ops.interpolate import BACKWARD_TOL as A_TOL
    from neo360_tpu_torch.ops.interpolate import table_sample_accumulate, \
        table_sample_accumulate_reference, table_sample_backward, \
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

    # A', dense contract: the grid lift (bf16 cotangent), the flat
    # tri-plane tables of two scenes (scene 1: views 3-5) and the flat
    # stacked local tables (scene 1: views 6-11); per scene 250 rays x 61
    # fine points, fg + bg
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
    uniform = {}
    for case, shape, u, mode, gdt, off in cases:
        cot = torch.randn(u.shape[:2] + (128,), device=dev,
                          generator=g).to(gdt)
        uniform[mode if off else "lift"] = (u, cot)
        # the plain version: autograd of the plain forward through an f32
        # table (the same values), rounded once to the table's bf16
        t32 = torch.zeros(shape, device=dev, requires_grad=True)
        fwd = table_sample_reference(t32, u, hw, mode, gdt, off)
        plain = lambda: torch.autograd.grad(fwd, t32, cot,
                                            retain_graph=True)[0].to(bf16)
        kernel = lambda: table_sample_backward(cot, u, shape, bf16, hw, mode,
                                               off)
        # the cotangent and uv read once, the dense bf16 table written once
        nbytes = (cot.numel() * cot.element_size() + u.numel() * 4
                  + t32.numel() * 2)
        _check("table_sample_bwd", f"dense {case}", kernel(), plain(),
               kernel, plain, torch, results, A_TOL, nbytes=nbytes,
               ops=2.0 * cot.numel() * 4,
               library_fn=_grid_sample_fns(torch, 128, bf16, u, hw, mode,
                                           cot))
        del fwd, t32

    # A', accumulate contract: one stage step's two scenes into one f32
    # accumulator per table, as the trainer makes them: scene 0 (view 0)
    # with ray-structured uv (250 fg + 250 bg rays x 61 points per view;
    # the local table: fg and bg views apart), scene 1 (view_offset 3 / 6)
    # with the dense case's uniform uv and cotangent
    acc_cases = [("plane zeros", (6, 121, 161, 512), "zeros", 3,
                  (3, 500, 61)),
                 ("local border", (12, 121, 161, 512), "border", 6,
                  (6, 250, 61))]
    for label, shape, mode, off, (b, n_rays, s) in acc_cases:
        calls = [("ray uv, view_offset=0", _ray_uv(torch, g, b, n_rays, s),
                  None, 0),
                 (f"uniform uv, view_offset={off}", *uniform[mode], off)]
        calls = [(what, u, torch.randn(u.shape[:2] + (128,), device=dev,
                                       generator=g) if cot is None else cot,
                  o) for what, u, cot, o in calls]
        acc = torch.zeros(shape, device=dev)
        ref = torch.zeros(shape, device=dev)
        for _, u, cot, o in calls:
            table_sample_accumulate(cot, u, acc, hw, mode, o)
            table_sample_accumulate_reference(cot, u, ref, hw, mode, o)
        acc_t, ref_t = acc.clone(), ref.clone()   # timed adds go here
        for what, u, cot, o in calls:
            kernel = lambda: table_sample_accumulate(cot, u, acc_t, hw, mode,
                                                     o)
            plain = lambda: table_sample_accumulate_reference(cot, u, ref_t,
                                                              hw, mode, o)
            # the cotangent and uv read once; every accumulator row the
            # points touch read and written once
            rows = _rows_read(shape, u, hw, mode, o)
            nbytes = (cot.numel() * 4 + u.numel() * 4
                      + rows * shape[-1] * 4 * 2)
            _check("table_sample_bwd", f"accumulate {label} {what}", acc,
                   ref, kernel, plain, torch, results, A_TOL, nbytes=nbytes,
                   ops=2.0 * cot.numel() * 4,
                   library_fn=_grid_sample_fns(torch, 128, bf16, u, hw, mode,
                                               cot),
                   main=label.startswith("plane") and o == 0)
        del acc, ref, acc_t, ref_t

    # B': one scene's 250 rays, proposal (65 points) and fine (61) levels;
    # the neo360 step's 500 rays, its coarse (129) and merged fine (385)
    # levels; the loss reads rgb and both weight histograms
    for b, s in ((250, 65), (250, 61), (500, 129), (500, 385)):
        args = _composite_args(torch, g, b, s)
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
        # per sample and branch: rgb, sigma, t and one weight cotangent
        # read, d rgb and d sigma written; per ray: dirs, far and the rgb
        # cotangent read
        _check("composite_nerfpp_bwd", f"B={b} S={s}", list(kernel()),
               list(plain()), kernel, plain, torch, results, B_TOL,
               nbytes=4.0 * b * (2 * 10 * s + 7), ops=2 * 40.0 * b * s,
               main=s == 61)

    # A', dense contract, at the neo360 preset's f32 grid lift (the
    # per-step trainer's one lift backward per step)
    shape = (3, 121, 161, 2048)
    u = uv(3, 64 ** 3, 1.5)
    cot = torch.randn(3, 64 ** 3, 512, device=dev, generator=g)
    t32 = torch.zeros(shape, device=dev, requires_grad=True)
    fwd = table_sample_reference(t32, u, hw, "zeros", f32)
    plain = lambda: torch.autograd.grad(fwd, t32, cot, retain_graph=True)[0]
    kernel = lambda: table_sample_backward(cot, u, shape, f32, hw, "zeros")
    _check("table_sample_bwd", "dense neo360 lift zeros f32 cotangent",
           kernel(), plain(), kernel, plain, torch, results, A_TOL,
           nbytes=cot.numel() * 4 + u.numel() * 4 + t32.numel() * 4,
           ops=2.0 * cot.numel() * 4,
           library_fn=_grid_sample_fns(torch, 512, f32, u, hw, "zeros", cot))
    del fwd, t32, cot, u

    # C': the grid latent of one scene, neo360_fast (bf16, Z = 32) and the
    # neo360 preset (f32, Z = 64)
    for dt, shape, main in ((bf16, (3, 64, 64, 32, 512), True),
                            (f32, (3, 64, 64, 64, 512), False)):
        nv, x, y, z, c = shape
        args = [torch.randn(shape, device=dev, generator=g).to(dt)] + [
            (torch.randn(shape[:4], device=dev, generator=g) * 3).to(dt)
            for _ in range(3)]
        cots = [torch.randn(s, device=dev, generator=g).to(dt) for s in
                ((nv, y, z, c), (nv, x, z, c), (nv, x, y, c))]
        leaves = [a.detach().requires_grad_() for a in args]
        floors = pillar_collapse_reference(*leaves)
        plain = lambda: torch.autograd.grad(floors, leaves, cots,
                                            retain_graph=True)
        kernel = lambda: pillar_collapse_backward(args, cots)
        cells = args[1].numel()
        floor_elems = sum(t.numel() for t in cots)
        # the latent, 3 logits and 3 floor cotangents read, d latent and 3
        # d logits written; per cell and floor ~4 C-wide multiply-adds
        name = {bf16: "bf16", f32: "f32"}[dt]
        _check("pillar_collapse_bwd", f"latent {shape} {name}",
               list(kernel()), list(plain()), kernel, plain, torch, results,
               [C_TOL["latent"]] + [C_TOL["logit"][dt]] * 3,
               nbytes=args[0].element_size() * (2 * args[0].numel()
                                                 + 6 * cells + floor_elems),
               ops=3.0 * (args[0].numel() * 8 + cells * 8), main=main)
        del args, cots, leaves, floors
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

    cfg = _tiny_cfg(seed=SEED, stage_k=2, ray_batch_size=32)
    cli.float32_matmuls(cfg, torch.device("cuda"))
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


def phase_train_main_path(torch, keep: str):
    """`cli.run_train` at full neo360_fast width: 3 stages of K=32, S=2,
    500 rays per step, on 3 in-memory 320x240 scenes (the third under
    torch.profiler), then its validation render and checkpoint, copied to
    `keep`. Returns the path's launches, each stage's launches, the
    unprofiled stages' seconds and the peak memory."""
    import shutil

    import numpy as np

    from neo360_tpu_torch import cli
    from neo360_tpu_torch.config import preset
    from neo360_tpu_torch.data.fixtures import MemoryScenes
    from neo360_tpu_torch.models import neo360
    from neo360_tpu_torch.train import loop

    with tempfile.TemporaryDirectory() as tmp:
        cfg = preset("neo360_fast", seed=SEED, run_max_steps=96,
                     save_every_steps=96, steps_per_call=32,
                     log_every_steps=32, ckpt_dir=tmp, device="cuda")
        print(f"[train] {cfg.exp_type}: img_wh {cfg.img_wh}, bf16 "
              f"{cfg.bf16}, K={cfg.stage_k}, S={cfg.stage_scenes}, "
              f"{cfg.ray_batch_size} rays/step, 3 stages, grid "
              f"{cfg.grid_size or (64, 64, 32)}, lift {cfg.lift_dim}")
        datasets = tuple(MemoryScenes(3, cfg.img_wh, cfg.num_src_views,
                                      split=split,
                                      ray_batch_size=cfg.ray_batch_size)
                         for split in ("train", "val"))
        before = cli.build_model(cfg, "cpu").state_dict()
        losses, seconds, per_stage = [], [], []
        plain_loss, plain_factory = (neo360.neo360_loss,
                                     loop.make_scene_stage_trainer)
        fns = counters()

        def recorded_loss(out, target):
            loss, l1 = plain_loss(out, target)
            losses.append(loss.detach())
            return loss, l1

        def timed_factory(*a, **kw):
            run = plain_factory(*a, **kw)

            def timed(*args):
                before = _read(fns)
                if len(per_stage) == 2:     # the third stage: profiled
                    box = []
                    _profile(torch, lambda: box.append(run(*args)),
                             "steady training stage (K=32, S=2)")
                    metrics = box[0]
                else:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    metrics = run(*args)
                    torch.cuda.synchronize()
                    seconds.append(time.perf_counter() - t)
                after = _read(fns)
                per_stage.append({k: after[k] - before[k] for k in after})
                return metrics
            return timed

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
        launches = _read(fns)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(os.path.join(tmp, "exp", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        ckpts = sorted(os.listdir(os.path.join(tmp, "exp", "checkpoints")))
        if "ckpt_00000096.pt" in ckpts:
            shutil.copy(os.path.join(tmp, "exp", "checkpoints",
                                     "ckpt_00000096.pt"), keep)

    values = torch.stack(losses).float().cpu().numpy()
    rays = cfg.ray_batch_size * cfg.stage_k
    for i, s in enumerate(seconds):
        print(f"[train] stage {i}: {s:.3f} s, {rays / s:.0f} train rays/s")
    print(f"[train] run_train wall {wall:.3f} s (model build, sampling, 3 "
          f"stages, one under the profiler, validation render, "
          f"checkpoint); peak device memory {peak:.2f} GiB")
    print(f"[train] losses: {len(values)} (step x scene), first "
          f"{values[:2].mean():.4f}, last {values[-2:].mean():.4f}; "
          f"metrics.jsonl {records}; checkpoints {ckpts}")
    print(f"[train] launches on the training path: {launches}; per stage: "
          f"{per_stage}")
    if len(values) != 3 * cfg.stage_k * cfg.stage_scenes or \
            not np.isfinite(values).all():
        raise AssertionError(f"non-finite or missing losses: {values}")
    if state.step != 96 or "ckpt_00000096.pt" not in ckpts or not any(
            "val_psnr" in r and np.isfinite(r["val_psnr"]) for r in records):
        raise AssertionError("run_train did not validate and checkpoint "
                             "at step 96")
    want = (cfg.stage_scenes, 4 * cfg.stage_scenes * cfg.stage_k)
    got = [(n["table_sample_bwd"], n["table_sample_bwd_acc"])
           for n in per_stage]
    print(f"[train] kernel A' per stage (dense, accumulate): {got}, "
          f"expected {want} (the lift once per scene; 3 planes + 1 local "
          f"table per scene-step)")
    if len(got) != 3 or any(x != want for x in got):
        raise AssertionError(f"kernel A' launches per stage {got}, "
                             f"expected {want}")
    # B' once per level (proposal, fine) per scene-step; C and C' once per
    # scene (its one encode)
    want = (2 * cfg.stage_scenes * cfg.stage_k, cfg.stage_scenes,
            cfg.stage_scenes)
    got = [(n["composite_nerfpp_bwd"], n["pillar_collapse_fwd"],
            n["pillar_collapse_bwd"]) for n in per_stage]
    print(f"[train] kernels B', C, C' per stage: {got}, expected {want} (B' "
          f"per level and scene-step, C and C' per scene)")
    if any(x != want for x in got):
        raise AssertionError(f"kernel B' / C / C' launches per stage {got}, "
                             f"expected {want}")
    # A once per scene (its one encode's lift); the fine level's tri-plane
    # and local gathers once each per scene-step
    sk = cfg.stage_scenes * cfg.stage_k
    want = (cfg.stage_scenes, sk, sk)
    got = [(n["table_sample_fwd"], n["triplane_sample_fwd"],
            n["local_sample_fwd"]) for n in per_stage]
    print(f"[train] kernels A, A-tri, A-loc per stage: {got}, expected "
          f"{want} (A per scene, the fused gathers per scene-step)")
    if any(x != want for x in got):
        raise AssertionError(f"kernel A / A-tri / A-loc launches per stage "
                             f"{got}, expected {want}")
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
    return launches, per_stage, seconds, peak


def phase_small_neo360_step(torch):
    """One tiny float32 per-step training step of the neo360 preset (grid
    (8, 8, 40): kernel C's four z chunks; deterministic sampling) on the
    card against the same step on the CPU, TF32 off: the loss, every
    parameter's gradient and the BatchNorm buffers the step commits.

    Tolerances: the loss 1e-5 relative; gradients 2e-3 of the largest entry
    (the float32 conditioning of this loss, measured against the JAX
    package in tests/test_torch_neo360_ref.py); BatchNorm buffers 1e-4
    relative plus 1e-5 of the largest."""
    import numpy as np

    from neo360_tpu_torch import cli
    from neo360_tpu_torch.config import preset
    from neo360_tpu_torch.data.fixtures import MemoryScenes
    from neo360_tpu_torch.ops import kernels
    from neo360_tpu_torch.train import loop

    cfg = preset("neo360", seed=SEED, grid_size=(8, 8, 40), encoder_width=64,
                 num_coarse_samples=8, num_fine_samples=6, img_wh=(40, 30))
    cli.float32_matmuls(cfg, torch.device("cuda"))
    batch = MemoryScenes(2, (40, 30), 3, split="train", ray_batch_size=32
                         ).sample_train(np.random.default_rng(SEED))
    runs = {}
    for dev in ("cpu", "cuda"):
        model = cli.build_model(cfg, dev).train()
        grads = []

        class Record:   # keeps the step's gradients, changes nothing
            def __init__(self, params):
                pass

            def step(self, gr):
                grads.append([x.detach().cpu() for x in gr])

        loss_fn = cli.make_loss_fn(cfg, model, randomized=False)
        losses = []

        def recorded(b, gen):
            loss, metrics = loss_fn(b, gen)
            losses.append(float(loss.detach()))
            return loss, metrics

        state = loop.create_train_state(model, Record)
        step = loop.make_train_step(recorded, with_model_state=True)
        step(state, {k: torch.as_tensor(batch[k], device=dev)
                     for k in cli.STEP_KEYS}, None)
        runs[dev] = (losses[0], grads[0],
                     {k: v.detach().cpu() for k, v in
                      model.named_buffers()})
    (loss_c, g_c, bn_c), (loss_g, g_g, bn_g) = runs["cpu"], runs["cuda"]
    scale = max(float(x.abs().max()) for x in g_c)
    worst = max(float((a - b).abs().max()) / scale for a, b in zip(g_g, g_c))
    bn_res = [kernels.compare(bn_g[k], bn_c[k], rtol=1e-4, atol_frac=1e-5)
              for k in sorted(bn_c)]
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    print(f"[small-neo360] per-step f32 step, grid (8,8,40), card vs CPU: "
          f"loss rel {loss_rel:.3e} (tolerance 1e-5), gradients max "
          f"{worst:.3e} of the largest entry (tolerance 2e-3), BatchNorm "
          f"buffers max rel {max(r['max_rel'] for r in bn_res):.3e} "
          f"({len(bn_c)} buffers)")
    if not (loss_rel <= 1e-5 and worst <= 2e-3
            and all(r["ok"] for r in bn_res)):
        raise AssertionError("the neo360 step on the card disagrees with the "
                             "CPU")


# the neo360 phase: calls of one per-step training step each through
# cli.run_train (call 0 warms up, the last runs under the profiler)
NEO_STEPS = 10


def _neo360_step_launches(remat: bool) -> dict:
    """Kernel launches of one neo360 per-step training step, from the
    code: the encode samples the lift table once (kernel A; once more when
    the backward recomputes the remat'ed grid part) and collapses the
    pillars once (C); each of the two conditioned levels gathers the 3
    plane tables (A-tri) and its local table (A-loc) once and composites
    once (B); the backward scatters every table gradient under the dense
    contract (A': the lift once, each level's 3 planes and local table),
    and runs C' once and B' once per level."""
    return {"table_sample_fwd": 1 + int(remat), "triplane_sample_fwd": 2,
            "local_sample_fwd": 2,
            "table_sample_bwd": 1 + 2 * 4, "table_sample_bwd_acc": 0,
            "composite_nerfpp_fwd": 2, "composite_nerfpp_bwd": 2,
            "pillar_collapse_fwd": 1, "pillar_collapse_bwd": 1}


def phase_neo360_main_path(torch):
    """The neo360 preset at full width (conditioned coarse level, 128 +
    256 merged samples, grid 64^3, 512-channel lift, float32, the grid part
    recomputed in the backward), random seeded weights, 3 in-memory
    320x240 fixture scenes:
    - `cli.run_train` with the per-step trainer (stage_k 0), NEO_STEPS
      calls of one 500-ray step (call 0 warms up and is reported apart, the
      last runs under torch.profiler), then its validation render and
      checkpoint; every step launches the kernels `_neo360_step_launches`
      says, every loss is finite and every parameter and BatchNorm buffer
      moves (apart from the zero-gradient leaves);
    - the trained model encodes one scene (timed alone) and renders 2
      views through cli.make_render_fn at the CLI's 256-ray tiles, the
      second with the encode cached; 16 tiles of a third run under the
      profiler;
    - run_train turns TF32 off for this float32 model (it is switched on
      before the call);
    - models with and without the recompute, one step each in turn
      (on, off, on, off after a warm-up step each), for their step times
      and peak memory.
    Returns the path's launches (training and rendering), per training
    step and per view."""
    import gc

    import numpy as np

    from neo360_tpu_torch import cli
    from neo360_tpu_torch.config import preset
    from neo360_tpu_torch.data.fixtures import MemoryScenes
    from neo360_tpu_torch.models import neo360
    from neo360_tpu_torch.train import loop
    from neo360_tpu_torch.train.eval import evaluate

    dev = "cuda"
    fns = counters()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = preset("neo360", seed=SEED, run_max_steps=NEO_STEPS,
                     steps_per_call=1, save_every_steps=NEO_STEPS,
                     log_every_steps=1, ckpt_dir=tmp, device=dev)
        print(f"[neo360] {cfg.exp_type}: img_wh {cfg.img_wh}, bf16 "
              f"{cfg.bf16}, stage_k {cfg.stage_k} (per-step trainer), "
              f"{cfg.ray_batch_size} rays/step, {NEO_STEPS} steps, grid "
              f"{cfg.grid_size or (64, 64, 64)}, lift 512, "
              f"{cfg.num_coarse_samples or 128} + "
              f"{cfg.num_fine_samples or 256} samples, remat "
              f"{cfg.remat_encoder is not False}, chunk {cfg.chunk}")
        datasets = tuple(MemoryScenes(3, cfg.img_wh, cfg.num_src_views,
                                      split=split,
                                      ray_batch_size=cfg.ray_batch_size)
                         for split in ("train", "val"))
        before = cli.build_model(cfg, "cpu").state_dict()
        losses, seconds, per_call, peaks = [], [], [], []
        plain_loss = neo360.neo360_coarse_fine_loss
        plain_factory = loop.make_staged_trainer

        def recorded_loss(out, target):
            loss, l1 = plain_loss(out, target)
            losses.append(loss.detach())
            return loss, l1

        def timed_factory(step_fn):
            run = plain_factory(step_fn)

            def timed(*args):
                start = _read(fns)
                if len(per_call) == NEO_STEPS - 1:     # the last: profiled
                    box = []
                    _profile(torch, lambda: box.append(run(*args)),
                             "neo360 training step (500 rays)")
                    metrics = box[0]
                else:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    metrics = run(*args)
                    torch.cuda.synchronize()
                    seconds.append(time.perf_counter() - t)
                peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
                end = _read(fns)
                per_call.append({k: end[k] - start[k] for k in end})
                return metrics
            return timed

        for fn in fns.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        neo360.neo360_coarse_fine_loss = recorded_loss
        loop.make_staged_trainer = timed_factory
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            t0 = time.perf_counter()
            state = cli.run_train(cfg, datasets=datasets)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            neo360.neo360_coarse_fine_loss = plain_loss
            loop.make_staged_trainer = plain_factory
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32):
            raise AssertionError("run_train left TF32 on for a float32 model")
        with open(os.path.join(tmp, "exp", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        ckpts = sorted(os.listdir(os.path.join(tmp, "exp", "checkpoints")))
        raw = torch.load(os.path.join(tmp, "exp", "checkpoints",
                                      f"ckpt_{NEO_STEPS:08d}.pt"),
                         map_location="cpu", weights_only=True)

    values = torch.stack(losses).float().cpu().numpy()
    steady = seconds[1:]
    print(f"[neo360] train call 0 (warm-up): {seconds[0]:.3f} s; steady "
          f"s/step over {len(steady)} steps: median "
          f"{statistics.median(steady):.3f} (min {min(steady):.3f}, max "
          f"{max(steady):.3f}), "
          f"{cfg.ray_batch_size / statistics.median(steady):.0f} "
          f"train rays/s; peak device memory of the training steps "
          f"{max(peaks):.2f} GiB (remat on)")
    print(f"[neo360] run_train wall {wall:.3f} s (model build, {NEO_STEPS} "
          f"steps, one under the profiler, validation render, checkpoint); "
          f"losses first {values[0]:.4f}, last {values[-1]:.4f}; "
          f"metrics.jsonl val {[r for r in records if 'val_psnr' in r]}; "
          f"checkpoints {ckpts} (layout {sorted(raw)})")
    if len(values) != NEO_STEPS or not np.isfinite(values).all():
        raise AssertionError(f"non-finite or missing losses: {values}")
    if state.step != NEO_STEPS or "params" not in raw or not any(
            "val_psnr" in r and np.isfinite(r["val_psnr"]) for r in records):
        raise AssertionError(f"run_train did not validate and checkpoint at "
                             f"step {NEO_STEPS}")
    want = _neo360_step_launches(remat=True)
    print(f"[neo360] launches per training step: {per_call}; expected "
          f"{want}")
    if any(n != want for n in per_call):
        raise AssertionError(f"neo360 launches per step {per_call}, "
                             f"expected {want}")
    after = {k: v.detach().cpu() for k, v in
             state.model.state_dict().items()}
    still = [k for k, v in before.items()
             if torch.equal(v, after[k]) and not ZERO_GRAD.search(k)]
    print(f"[neo360] {len(before)} parameter and buffer tensors; unchanged: "
          f"{still}")
    if still:
        raise AssertionError(f"tensors the neo360 training did not move: "
                             f"{still}")
    train_launches = _read(fns)

    # serving: the trained weights, one scene encoded once
    model = state.model.eval()
    scenes = MemoryScenes(1, cfg.img_wh, cfg.num_src_views)
    samples = [dict(scenes.sample_test(0, d), scene_key=0) for d in range(3)]
    src = {k: torch.as_tensor(samples[0][k], device=dev)
           for k in cli.SRC_KEYS}
    with torch.inference_mode():
        model.encode(*(src[k] for k in cli.SRC_KEYS), True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.encode(*(src[k] for k in cli.SRC_KEYS), True)
        torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    render_fn = cli.make_render_fn(cfg, model, dev)
    for fn in fns.values():
        fn.launches = 0
    per_view, view_s = [], []

    def timed(sample):
        start = _read(fns)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = render_fn(sample)
        torch.cuda.synchronize()
        view_s.append(time.perf_counter() - t)
        end = _read(fns)
        per_view.append({k: end[k] - start[k] for k in end})
        w, h = cfg.img_wh
        for k, v in out.items():
            if v.shape[0] != w * h or not bool(torch.isfinite(v).all()):
                raise AssertionError(f"neo360 output {k}: shape "
                                     f"{tuple(v.shape)} or non-finite")
        return out

    views = list(evaluate(timed, samples[:2], cfg.img_wh))
    render_launches = _read(fns)
    tiles = -(-cfg.img_wh[0] * cfg.img_wh[1] // cfg.chunk)
    print(f"[neo360] encode {encode_s:.3f} s; view 0 encode + render "
          f"{view_s[0]:.3f} s, view 1 render {view_s[1]:.3f} s/view (encode "
          f"cached, {tiles} tiles of {cfg.chunk} rays); PSNR / SSIM "
          f"{[(round(v.psnr, 3), round(v.ssim, 4)) for v in views]}; "
          f"launches per view {per_view}")
    for v in views:
        if not (np.isfinite(v.psnr) and np.isfinite(v.rgb).all()
                and np.isfinite(v.depth).all()):
            raise AssertionError("neo360 view: non-finite output or metrics")
    # per tile both levels gather the planes (A-tri) and the local table
    # (A-loc) and composite (B); the first view also encodes (A once for
    # the lift, C once)
    want = [{"table_sample_fwd": first, "triplane_sample_fwd": 2 * tiles,
             "local_sample_fwd": 2 * tiles,
             "composite_nerfpp_fwd": 2 * tiles, "pillar_collapse_fwd": first}
            for first in (1, 0)]
    got = [{k: n[k] for k in want[0]} for n in per_view]
    if got != want:
        raise AssertionError(f"neo360 launches per view {got}, expected "
                             f"{want}")
    part = dict(samples[2], **{k: samples[2][k][:16 * cfg.chunk]
                              for k in cli.RAY_KEYS})
    _profile(torch, lambda: render_fn(part),
             f"neo360 render, 16 tiles of {cfg.chunk} rays (encode cached)")

    # the recompute's cost: a model with it and one without, both resident,
    # the same batches, a warm-up step each, then steps in turn on, off,
    # on, off; the peak is reset before each step
    del state, model, render_fn, views
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED)
    batches = [{k: torch.as_tensor(v, device=dev)[None] for k, v in
                datasets[0].sample_train(rng).items() if k in cli.STEP_KEYS}
               for _ in range(3)]
    runs = {}
    for remat in (True, False):
        c = cfg.replace(remat_encoder=remat)
        model = cli.build_model(c, dev).train()
        runs[remat] = (*cli._per_step_runner(c, model),
                       torch.Generator(dev).manual_seed(SEED))
    del model
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    step_s = {True: [], False: []}
    step_peak = {True: [], False: []}
    for i in range(3):
        for remat in (True, False):
            st, staged, gen = runs[remat]
            counts = _read(fns)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            staged(st, batches[i], gen)
            torch.cuda.synchronize()
            step_s[remat].append(time.perf_counter() - t)
            step_peak[remat].append(torch.cuda.max_memory_allocated()
                                    / 2 ** 30)
            n = _read(fns)
            got = {k: n[k] - counts[k] for k in n}
            if got != _neo360_step_launches(remat=remat):
                raise AssertionError(f"neo360 launches with remat {remat}: "
                                     f"{got}")
    for remat in (True, False):
        print(f"[neo360] remat {'on' if remat else 'off'}: steps "
              f"{[round(x, 4) for x in step_s[remat][1:]]} s (warm-up "
              f"{step_s[remat][0]:.3f} s), peak device memory "
              f"{max(step_peak[remat]):.2f} GiB (both models resident: "
              f"{resident:.2f} GiB)")
    del runs, batches
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: train_launches[k] + render_launches[k]
                for k in train_launches}
    return launches, per_call, per_view


# the optimize / finetune phase: steps of each mode, one per run_train
# call (the first warms up, the last runs under the profiler)
OPT_STEPS = 4
FT_STEPS = 3


def _optimize_step_launches() -> dict:
    """Kernel launches of one neo360_fast optimize or finetune step, from
    the code: the per-step trainer encodes once with the SpatialEncoder's
    latents given (cached) or computed without a kernel, so the lift
    samples its table once (A) and the pillars collapse once (C); the
    proposal level gathers nothing, the fine level gathers the 3 planes
    (A-tri) and its local table (A-loc) once, both levels composite (B);
    the backward scatters the lift table's gradient (`lift_proj` still
    trains), the 3 planes' and the local table's under the dense
    contract (A' 5 times), and runs C' once and B' once per level."""
    return {"table_sample_fwd": 1, "triplane_sample_fwd": 1,
            "local_sample_fwd": 1,
            "table_sample_bwd": 1 + 4, "table_sample_bwd_acc": 0,
            "composite_nerfpp_fwd": 2, "composite_nerfpp_bwd": 2,
            "pillar_collapse_fwd": 1, "pillar_collapse_bwd": 1}


def phase_optimize_finetune(torch, warm_path: str):
    """The optimize and LPIPS-finetune modes of `cli.run_train` at full
    neo360_fast width, warm-started from `warm_path` (phase 6's trained
    checkpoint), on 3 in-memory 320x240 scenes: OPT_STEPS optimize steps
    (fixed source views, latents cached), then FT_STEPS finetune steps
    (30x30 patches, 0.3 x LPIPS with synthetic weights), one step a call
    (the first warms up, the last runs under torch.profiler), then each
    run's validation render and checkpoint. Every step launches
    exactly `_optimize_step_launches()`, every loss is finite, the
    SpatialEncoder's tensors and every BatchNorm buffer equal the warm
    start's bit for bit and most trained tensors move. Returns the
    phase's launches and the launches of each step."""
    import numpy as np

    from neo360_tpu_torch import cli, weights
    from neo360_tpu_torch.config import preset
    from neo360_tpu_torch.data.fixtures import MemoryScenes
    from neo360_tpu_torch.nn.lpips import random_torch_state
    from neo360_tpu_torch.train import loop

    fns = counters()
    warm = weights.from_checkpoint(torch.load(warm_path, map_location="cpu",
                                              weights_only=True))
    want = _optimize_step_launches()
    per_step, total = [], {k: 0 for k in fns}
    with tempfile.TemporaryDirectory() as tmp:
        lpips = os.path.join(tmp, "lpips.pt")
        torch.save(random_torch_state(SEED), lpips)
        for mode, steps, flags in (
                ("optimize", OPT_STEPS, dict(is_optimize=True)),
                ("finetune", FT_STEPS, dict(finetune_lpips=True,
                                            lpips_weights=lpips))):
            cfg = preset("neo360_fast", seed=SEED, run_max_steps=steps,
                         steps_per_call=1, log_every_steps=1,
                         save_every_steps=steps, ckpt_dir=tmp,
                         exp_name=mode, ckpt_path=warm_path, device="cuda",
                         **flags)
            sampling = dict(optimize=cfg.is_optimize,
                            finetune_lpips=cfg.finetune_lpips)
            datasets = (MemoryScenes(3, cfg.img_wh, cfg.num_src_views,
                                     split="train",
                                     ray_batch_size=cfg.ray_batch_size,
                                     **sampling),
                        MemoryScenes(3, cfg.img_wh, cfg.num_src_views,
                                     split="val"))
            seconds, losses, steps_here = [], [], []
            plain_factory = loop.make_staged_trainer

            def timed_factory(step_fn):
                run = plain_factory(step_fn)

                def timed(*args):
                    start = _read(fns)
                    if len(steps_here) == steps - 1:   # the last: profiled
                        box = []
                        _profile(torch, lambda: box.append(run(*args)),
                                 f"neo360_fast {mode} step")
                        metrics = box[0]
                    else:
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        metrics = run(*args)
                        torch.cuda.synchronize()
                        seconds.append(time.perf_counter() - t)
                    end = _read(fns)
                    steps_here.append({k: end[k] - start[k] for k in end})
                    losses.append(float(metrics["loss"]))
                    return metrics
                return timed

            for fn in fns.values():
                fn.launches = 0
            loop.make_staged_trainer = timed_factory
            try:
                state = cli.run_train(cfg, datasets=datasets)
                torch.cuda.synchronize()
            finally:
                loop.make_staged_trainer = plain_factory
            launches = _read(fns)
            for k, n in launches.items():
                total[k] += n
            ckpts = sorted(os.listdir(os.path.join(tmp, mode,
                                                   "checkpoints")))
            rays = (datasets[0].patch_size ** 2 if cfg.finetune_lpips
                    else cfg.ray_batch_size)
            secs = [round(x, 4) for x in seconds]
            print(f"[{mode}] {steps} steps from {os.path.basename(warm_path)}"
                  f" (step 96 of phase 6): s/step {secs} (the first includes "
                  f"warm-up; the last step ran under the profiler), "
                  f"{rays / statistics.median(seconds[1:]):.0f} "
                  f"rays/s at {rays} rays/step; losses "
                  f"{[round(x, 4) for x in losses]}; checkpoints {ckpts}; "
                  f"launches per step {steps_here}")
            after = {k: v.detach().cpu() for k, v in
                     state.model.state_dict().items()}
            frozen = [k for k in warm if "spatial_encoder" in k
                      or k.endswith(("running_mean", "running_var"))]
            moved = [k for k in frozen if not torch.equal(warm[k], after[k])]
            trained = [k for k in warm if k not in frozen]
            changed = sum(not torch.equal(warm[k], after[k])
                          for k in trained)
            print(f"[{mode}] frozen tensors bit-equal to the warm start: "
                  f"{len(frozen) - len(moved)} / {len(frozen)}; trained "
                  f"tensors moved: {changed} / {len(trained)}")
            if moved or changed < 0.8 * len(trained):
                raise AssertionError(f"{mode}: frozen tensors moved "
                                     f"{moved[:5]} or too few trained "
                                     f"tensors moved ({changed})")
            if len(losses) != steps or not np.isfinite(losses).all():
                raise AssertionError(f"{mode}: losses {losses}")
            if state.step != steps or f"ckpt_{steps:08d}.pt" not in ckpts:
                raise AssertionError(f"{mode}: no checkpoint at {steps}")
            if any(n != want for n in steps_here):
                raise AssertionError(f"{mode}: launches per step "
                                     f"{steps_here}, expected {want}")
            per_step.extend(steps_here)
    return total, per_step


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

    cfg = _tiny_cfg(seed=SEED)
    cli.float32_matmuls(cfg, torch.device("cuda"))
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
    from neo360_tpu_torch.ops.interpolate import local_sample, \
        table_sample, triplane_sample
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
               "triplane_sample_fwd": triplane_sample,
               "local_sample_fwd": local_sample,
               "composite_nerfpp_fwd": composite_nerfpp,
               "pillar_collapse_fwd": pillar_collapse}
    for fn in counted.values():
        fn.launches = 0
    render_fn = cli.make_render_fn(cfg, model, dev)
    w, h = cfg.img_wh

    def timed(sample):
        before = _read(counted)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = render_fn(sample)
        torch.cuda.synchronize()
        timed.seconds.append(time.perf_counter() - t)
        after = _read(counted)
        timed.per_view.append({k: after[k] - before[k] for k in after})
        for k, v in out.items():
            if v.shape[0] != w * h or not bool(torch.isfinite(v).all()):
                raise AssertionError(f"output {k}: shape {tuple(v.shape)} or "
                                     f"non-finite values")
        return out

    timed.seconds, timed.per_view = [], []
    views = list(evaluate(timed, samples, cfg.img_wh))
    launches = _read(counted)
    for i, (v, s) in enumerate(zip(views, timed.seconds)):
        what = "encode + render" if i == 0 else "render"
        print(f"[main] view {i}: {what} {s:.3f} s ({w * h} rays), PSNR "
              f"{v.psnr:.3f} SSIM {v.ssim:.4f}")
        if not (np.isfinite(v.psnr) and np.isfinite(v.ssim)
                and np.isfinite(v.rgb).all() and np.isfinite(v.depth).all()):
            raise AssertionError(f"view {i}: non-finite output or metrics")
    print(f"[main] render s/view (views 1-2, encode cached): "
          f"{statistics.mean(timed.seconds[1:]):.3f}")
    print(f"[main] launches on the main path: {launches}; per view: "
          f"{timed.per_view}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: "
                             f"{missing}")
    # per view: A and C once for the scene's one encode (view 0); per
    # tile the fine level's tri-plane and local gathers and both levels'
    # composites
    tiles = -(-w * h // cfg.chunk)
    want = [{"table_sample_fwd": first, "triplane_sample_fwd": tiles,
             "local_sample_fwd": tiles, "composite_nerfpp_fwd": 2 * tiles,
             "pillar_collapse_fwd": first}
            for first in [1] + [0] * (len(views) - 1)]
    if timed.per_view != want:
        raise AssertionError(f"launches per view {timed.per_view}, expected "
                             f"{want}")
    _profile(torch, lambda: render_fn(samples[1]),
             "rendered view (encode cached)")
    return launches, timed.per_view


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

    t0 = time.perf_counter()

    def done(phase):
        print(f"[time] {phase} done at {time.perf_counter() - t0:.1f} s")

    phase_card(torch)
    phase_build()
    done("build")
    checks = phase_kernels(torch) + phase_backward_kernels(torch)
    done("kernels")
    phase_small_reference(torch)
    phase_small_train(torch)
    phase_small_neo360_step(torch)
    done("small card-vs-CPU checks")
    work = tempfile.TemporaryDirectory()
    trained = os.path.join(work.name, "neo360_fast_96.pt")
    launches, per_stage, _, _ = phase_train_main_path(torch, trained)
    done("neo360_fast training")
    from neo360_tpu_torch.config import preset
    serve_launches, per_view = phase_main_path(
        torch, preset("neo360_fast", seed=SEED))
    done("neo360_fast serving")
    neo_launches, neo_per_step, neo_per_view = phase_neo360_main_path(torch)
    done("neo360 training and serving")
    opt_launches, opt_per_step = phase_optimize_finetune(torch, trained)
    work.cleanup()
    done("neo360_fast optimize and finetune")

    # launches per steady training stage (the second), per rendered view
    # with the encode cached (the second view) and per optimize step; the
    # line's launches sum the main paths (neo360_fast training and
    # serving, neo360 training and serving, neo360_fast optimize and
    # finetune), each counted from 0
    steady = _by_kernel(per_stage[1])
    neo_step, neo_view = _by_kernel(neo_per_step[1]), neo_per_view[1]
    opt_step = _by_kernel(opt_per_step[0])
    total = _by_kernel(launches)
    for k, n in serve_launches.items():
        total[k] += n
    for k, n in _by_kernel(neo_launches).items():
        total[k] += n
    for k, n in _by_kernel(opt_launches).items():
        total[k] += n
    print(f"[kernel] launches: A' per stage dense "
          f"{per_stage[1]['table_sample_bwd']}, accumulate "
          f"{per_stage[1]['table_sample_bwd_acc']}")
    entries = []
    for name, (source, replaces) in KERNELS.items():
        rows = [r for r in checks if r["name"] == name]
        main = next((r for r in rows if r["main"]), rows[0])
        print(f"[kernel] {name}: neo360_fast {steady[name]} launches per "
              f"training stage, {per_view[1].get(name, 0)} per rendered "
              f"view; neo360 {neo_step[name]} per training step, "
              f"{neo_view.get(name, 0)} per rendered view; neo360_fast "
              f"{opt_step[name]} per optimize step; "
              f"{main['case']}: {main['ms']:.4f} ms (device "
              f"{main['device_ms']:.4f} ms), bound {main['bound_ms']:.4f} ms "
              f"({main['bound_by']}), share "
              f"{_share(main['bound_ms'], main['ms'])} (device "
              f"{_share(main['bound_ms'], main['device_ms'])})")
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": total[name],
                        "max_abs_err": max(r["max_abs"] for r in rows),
                        "ms": main["ms"], "device_ms": main["device_ms"],
                        "plain_ms": main["plain_ms"],
                        "bound_ms": main["bound_ms"],
                        "bound_by": main["bound_by"],
                        "library_ms": main["library_ms"]})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
