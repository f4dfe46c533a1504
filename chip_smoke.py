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
   then (`phase_sync`) the syncs of one tiny neo360 render tile and one
   per-step training step under `torch.cuda.set_sync_debug_mode("warn")`,
   the first call and the second, with the constants each built and
   served (`core/constants.py`), on a "[sync]" line: the second of
   each must neither synchronise nor build a constant;
6. the neo360_fast training main path: `cli.run_train` at full width
   (random seeded weights, bf16) on 3 in-memory 320x240 fixture scenes,
   3 stages of K=32 steps, S=2 scenes and 500 rays per step (the third
   under `torch.profiler`, whose top device ops are printed), then its
   validation render and checkpoint; every step's loss must be finite,
   every parameter and BatchNorm buffer must move (apart from the leaves
   whose gradient is zero by construction), all eight NeO-360 kernels must
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
   the warm start's bits and the trained tensors move;
10. the vanilla NeRF (`phase_vanilla_main_path`): a 320x240 micro scene
   written by the port's `make_micro_scene`, `cli.run_train` at full
   width (8 x 256 MLP, 64 + 128 samples, 2048 rays a step, the ray-buffer
   trainer) for VAN_STEPS steps, then `cli.run_eval` full_eval of its 2
   test views and vis_only with VIS_FRAMES spiral frames; every step
   launches kernels D and D' twice and nothing else, every view D twice
   per tile;
11. PixelNeRF (`phase_pixelnerf_main_path`): `cli.run_train` at full
   width (ResNet34 encoder trained every step, 4 x 128 MLP, 64 + 64
   samples, 512 rays, float32) for PIX_STEPS steps on 3 in-memory
   scenes, then 2 rendered views of one scene with one encode; every step
   launches A, A' (dense), D and D' twice each, every view A and D twice
   per tile;
12. MipNeRF-360 (`phase_mipnerf360_main_path`): a 320x240 micro scene
   written by `make_micro_scene`, `cli.run_train` at full width (8 x 1024
   NeRF MLP, two 4 x 256 proposal MLPs, 64 + 64 + 32 samples, lifted IPE,
   float32, 2048 rays a step, the ray-buffer trainer) for MIP_STEPS
   steps, then `cli.run_eval` full_eval of its 2 test views and vis_only
   with VIS_FRAMES spiral frames at --chunk 4096, and one profiled tile;
   every step launches kernels E and E' 3 times and nothing else, every
   view E 3 times per tile;
13. data parallelism (`phase_data_parallel`): two ranks share the card
   over gloo (`parallel.sharding.launch`) and train 2 full-width
   neo360_fast stages through `cli.run_train`, then full_eval 3 views,
   against one rank in this process run twice (the spread of two
   one-rank runs bounds the ranks' parameters and renders); the ranks
   hold the same bits, every BatchNorm buffer too, launch per stage what
   one rank launches, and rank 1 writes no file; one NCCL rank runs the
   same stages; two gloo ranks run 3 MipNeRF-360 steps and one LPIPS
   finetune step, their first gradients held to one rank's;
14. the JAX package's helpers (`phase_helpers`): grid_sample_2d (kernel
   G, and G' in its image gradient) against its plain versions at the
   plane-sweep warp's shape, an RGB image's and PixelNeRF's latent (f32
   and bf16), with time, bound, F.grid_sample's time and the time of the
   table route it replaced (build_corner_table + A, A' + the table's
   transpose), one launch of G a call and of G' a backward, none of A or
   A'; PixelNeRF's two levels per training step and per render tile on
   G / G' against its table route; homography_warp (one G, and one G'
   in its gradient), volume_rendering_volsdf, the ray helpers and
   charbonnier_loss on the card against the CPU; profiling.trace around
   one full-width neo360_fast render tile (its span and the tri-plane
   gather's kernel in the Chrome trace) and a view's spans (rays/s on the
   device timeline, each model phase's device ms); the MipNeRF-360 NeRF
   MLP sharded by tp_param_shardings over two gloo ranks on the CPU
   (DTensor's all-gather of CUDA tensors through gloo, the only backend
   for two ranks on one card, segfaults) against the unsharded forward;
15. the port's benchmark (`phase_bench`): the kernels the NeRFTP width
   knobs reshape (the fused gathers and A' accumulate at plane_dim /
   local_proj_dim of 32, 64 and 96, kernel C at those latent widths, bf16
   and f32) against their plain versions, one tiny f32 stage of a
   narrowed model (plane_dim 64, local_proj_dim 64, pillar width 16, one
   DepthPillarEncoder hidden layer) on the card against the CPU, and
   `neo360_tpu_torch.bench` in this process with short windows:
   neo360_fast training (3 timed stages), its render (2 timed views) and
   neo360 per-step training (3 timed steps), each result on a "[bench]"
   line, the launches of each run's last window asserted.
Kernel D / D' are also checked against their plain versions at the
baselines' shapes in phase 3, A / A' at the PixelNeRF levels, and E / E'
at MipNeRF-360's levels and render tiles, with rays at the tie acc == 1
and the infinite last interval.

After each phase that renders (phase 13's ranks aside) a "[graph]" line
counts its tiles by how they ran: captured into the tile renderer's CUDA
graph, replayed from it, or eager; the neo360 phase must replay some.
Each kernel's launches per training stage or step and per rendered view
follow the last phase. The line before the last is {"kernels": [...]}
(the fourteen kernels; launches: the sum over the eight main paths of
phases 6-12 and the bench runs of phase 15, each counted from 0, and for G / G' the sum over phase 14's
runs of grid_sample_2d and homography_warp, each counted from 0; phase
13's ranks count in their own processes and are not in it), the
last is {"ok": true, "device": {...}}. Requires a CUDA device: it exits 2
without one, or without the neo360_tpu_torch package beside it.
"""

from __future__ import annotations

import json
import math
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
    "composite_vanilla_fwd": ("neo360_tpu_torch/csrc/composite_vanilla.cu",
                              "neo360_tpu/core/render.py:26"),
    "composite_vanilla_bwd": (
        "neo360_tpu_torch/csrc/composite_vanilla_bwd.cu",
        "neo360_tpu/core/render.py:26"),
    "composite_mip_fwd": ("neo360_tpu_torch/csrc/composite_mip.cu",
                          "neo360_tpu/core/render.py:124"),
    "composite_mip_bwd": ("neo360_tpu_torch/csrc/composite_mip_bwd.cu",
                          "neo360_tpu/core/render.py:124"),
}
# the kernels of phase 14's path (grid_sample_2d, homography_warp), which
# no training or serving path launches: (source, the JAX function they
# replace); their launches in the {"kernels": ...} line are phase 14's
HELPER_KERNELS = {
    "grid_sample_fwd": ("neo360_tpu_torch/csrc/grid_sample.cu",
                        "neo360_tpu/ops/interpolate.py:62"),
    "grid_sample_bwd": ("neo360_tpu_torch/csrc/grid_sample_bwd.cu",
                        "neo360_tpu/ops/interpolate.py:62"),
}
# leaves whose gradient is zero by construction: conv biases ahead of
# train-mode BatchNorm, and the pillar heads' biases (a softmax ignores a
# constant shift); rounding noise may still move them
ZERO_GRAD = re.compile(r"encoder\.(floorplan_(yz|xz|xy)\.conv[0-3]"
                       r"|tri_pillar\.out_(yz|xz|xy))\.bias$")


def counters():
    """The counters read: the C entries of the training and serving paths
    (KERNELS; kernel A' has one entry for each of its two contracts,
    dense and accumulate). Phase 14 counts HELPER_KERNELS itself: no
    training or serving path runs them."""
    from neo360_tpu_torch.ops import kernels
    return tuple(k for k in kernels.launches if k not in HELPER_KERNELS)


def _read(names) -> dict:
    """Counter name -> launches so far (`kernels.launches`)."""
    from neo360_tpu_torch.ops import kernels
    return {k: kernels.launches[k] for k in names}


def _zero(names) -> None:
    """Count the `names`' launches from 0 again."""
    from neo360_tpu_torch.ops import kernels
    kernels.launches.update(dict.fromkeys(names, 0))


def _by_kernel(counts) -> dict:
    """Counter values summed per kernel (A' = dense + accumulate)."""
    out = {k: v for k, v in counts.items() if k != "table_sample_bwd_acc"}
    out["table_sample_bwd"] += counts["table_sample_bwd_acc"]
    return out


def _graph_line(what: str, before: dict) -> dict:
    """Print a "[graph]" line: the tiles rendered since `before` (the
    process's `profiling.graphs`) by how they ran, captured into the tile
    renderer's CUDA graph, replayed from it or eager. Returns the counts
    now."""
    from neo360_tpu_torch.train import profiling
    now = dict(profiling.graphs)
    got = {k: now[k] - before[k] for k in now}
    print(f"[graph] {what}: {got['captured']} captured, {got['replayed']} "
          f"replayed, {got['eager']} eager tiles")
    if what.startswith("neo360 ") and not got["replayed"]:
        raise AssertionError(f"{what}: no tile replayed from a CUDA graph")
    return now


def _bound(nbytes: float, ops: float):
    """(least ms the card could take, "bytes" or "operations")."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def _share(bound_ms: float, ms) -> str:
    return f"{bound_ms / ms:.1%}" if ms else "not measured"


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
                         r"|table_scatter|round_to_bf16|grid_round_bf16"
                         r"|grid_sample|grid_scatter"
                         r"|composite_(nerfpp|vanilla|mip)(_bwd)?"
                         r"|pillar_(collapse|weights"
                         r"|softmax|dlogit|dlatent))_kernel\b")


# device kernels by class, first match wins: the port's kernels, matrix
# products (cuBLAS / CUTLASS), convolutions, reductions and scans, copies
# and casts, and the rest (elementwise)
OP_CLASSES = (
    ("port kernels", PORT_KERNEL),
    ("matmul", re.compile(r"gemm|cutlass|xmma|cublas|gemv", re.I)),
    ("conv", re.compile(r"conv|cudnn|implicit_", re.I)),
    ("reduce/scan", re.compile(r"reduce|scan|sort|softmax|cumsum|norm",
                               re.I)),
    ("copy/cast", re.compile(r"copy|cat|index|gather|scatter|memcpy|memset",
                             re.I)),
)


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
    classes = {}
    for ms, n, key in kernels_:
        cls = next((c for c, pat in OP_CLASSES if pat.search(key)), "other")
        t, k = classes.get(cls, (0.0, 0))
        classes[cls] = (t + ms, k + n)
    print(f"[profile] {label} by class: " + "; ".join(
        f"{c} {t:.3f} ms {t / max(busy, 1e-9):.1%} x{k}"
        for c, (t, k) in sorted(classes.items(), key=lambda x: -x[1][0])))
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


# profiles `_trusted_device_ms` takes before it gives up: late in this
# script the profiler often misses launches of a short call
PROFILE_TRIES = 5


def _device_ms(torch, fn, calls: dict = None) -> dict:
    """{kernel name: device ms per call} of `fn` over TIMED_RUNS calls
    under torch.profiler, after a warm-up (memsets included); `calls`, if
    given, gets each kernel's recorded launches. For a kernel of a few
    microseconds a CUDA-event time around one call measures the caller's
    host work; this does not."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TIMED_RUNS):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    if calls is not None:
        calls.update({e.key: e.count for e in events})
    return {e.key: e.self_device_time_total / 1e3 / TIMED_RUNS
            for e in events}


def _trusted_device_ms(torch, fn, bound_ms: float = 0.0, port: bool = True):
    """Device ms per call of `fn` (all its kernels), or None where the
    profiler missed events: a run counts only if it recorded a port
    kernel (unless `port` is False: `fn` launches none), every port
    kernel it recorded ran at least once a call, and the total is not
    below `bound_ms`, the least time the work can take. Up to
    PROFILE_TRIES runs; each rejected one is printed."""
    for _ in range(PROFILE_TRIES):
        calls = {}
        per = _device_ms(torch, fn, calls)
        seen = [n for k, n in calls.items() if PORT_KERNEL.search(k)]
        total = sum(per.values())
        if (seen or not port) and min(seen, default=TIMED_RUNS) \
                >= TIMED_RUNS and total >= bound_ms:
            return total
        print(f"[profile] device time not trusted: {total * 1e3:.1f} us a "
              f"call, bound {bound_ms * 1e3:.1f} us, port kernels recorded "
              f"{seen} times in {TIMED_RUNS} calls")
    return None


def _fmt_ms(ms, scale: float = 1.0, digits: int = 4) -> str:
    """A device time for printing: `ms` * `scale`, or "not measured"."""
    return "not measured" if ms is None else f"{ms * scale:.{digits}f}"


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
    bound_ms, bound_by = _bound(nbytes, ops)
    device_ms = _trusted_device_ms(torch, kernel_fn, bound_ms)
    plain_ms = _median_ms(plain_fn, torch)
    library_ms = _median_ms(library_fn, torch) if library_fn else None
    ok = all(r["ok"] for r in res)
    lib = f"{library_ms:.4f} ms" if library_ms is not None else "none"
    print(f"[kernel] {name} {case}: max_abs {max_abs:.3e} max_rel "
          f"{max_rel:.3e} kernel {ms:.4f} ms (device {_fmt_ms(device_ms)} ms) "
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


def _grid_sample_tables(image, uv, mode):
    """grid_sample_2d through the image's corner table and kernel A, the
    route `ops/interpolate.py:grid_sample_2d` took on the card before
    kernels G / G' (a yardstick only): C padded with zeros to 16 bytes of
    the image's type, one `build_corner_table`, one `table_sample`, the
    padding sliced off; float32 out. Its gradient is kernel A' (dense) and
    the table's plain transpose. C up to kernel A's 1024 channels."""
    import torch.nn.functional as F

    from neo360_tpu_torch.ops.interpolate import build_corner_table, \
        table_sample
    c = image.shape[-1]
    multiple = 16 // image.element_size()
    padded = -(-c // multiple) * multiple
    if padded != c:
        image = F.pad(image, (0, padded - c))
    out = table_sample(build_corner_table(image, mode), uv,
                       tuple(image.shape[1:3]), mode)
    return out[..., :c]


def phase_kernels(torch):
    from neo360_tpu_torch.core.render import composite_mip, \
        composite_mip_reference, composite_nerfpp, \
        composite_nerfpp_reference, composite_vanilla, \
        composite_vanilla_reference
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

    # Kernel D: a vanilla training step's two levels (2048 rays x 65 and
    # x 193 points), a PixelNeRF step's (512 x 65, x 129) and a 256-ray
    # render tile of each model's fine level, white background off (the
    # presets'); no PyTorch call computes the composite
    for b, s in VANILLA_SHAPES:
        args = _vanilla_args(torch, g, b, s)
        kernel = lambda: composite_vanilla(*args, False)
        plain = lambda: composite_vanilla_reference(*args, False)
        # per sample: rgb, sigma, t read, one weight written; per ray:
        # dirs read, comp, acc, depth written
        _check("composite_vanilla_fwd", f"B={b} S={s}", list(kernel()),
               list(plain()), kernel, plain, torch, results,
               nbytes=4.0 * b * (6 * s + 8), ops=20.0 * b * s,
               main=(b, s) == (2048, 193))

    # Kernel E: a MipNeRF-360 training step's NeRF level (2048 rays x 32
    # intervals) and proposal level (x 64), and a 4096-ray render tile's
    # levels; opaque background (the model's), background 1.0; ray 0 of
    # each case has acc exactly 1 (the tie of max(0, 1 - acc)) and every
    # ray's last interval is infinite; no PyTorch call computes the
    # composite
    for b, s in MIP_SHAPES:
        args = _mip_args(torch, g, b, s)
        kernel = lambda: composite_mip(*args, 1.0, True)
        plain = lambda: composite_mip_reference(*args, 1.0, True)
        out, ref = list(kernel()), list(plain())
        _mip_ties(f"B={b} S={s}", out[2], ref[2])
        # per interval: density, rgb, tdist read, one weight written; per
        # ray: dirs and the last edge read, rgb, acc, depth written
        _check("composite_mip_fwd", f"B={b} S={s}", out, ref, kernel, plain,
               torch, results, nbytes=4.0 * b * (6 * s + 9),
               ops=15.0 * b * s, main=(b, s) == (2048, 32))

    # Kernel A at the PixelNeRF levels: the 512-channel pixel latent of 3
    # views as one zeros-padded table (f32, and bf16 as the JAX
    # acceptance ran), sampled at a training step's coarse (512 x 65) and
    # fine (512 x 129) points of a fixture view, projected with (f, -f)
    for dt in (f32, bf16):
        table = torch.randn(3, 121, 161, 2048, device=dev,
                            generator=g).to(dt)
        for n_rays, s in ((512, 65), (512, 129)):
            u = _pixelnerf_uv(torch, view, n_rays, s)
            kernel = lambda: table_sample(table, u, hw, "zeros", dt)
            plain = lambda: table_sample_reference(table, u, hw, "zeros",
                                                   dt)
            rows = _rows_read(table.shape, u, hw, "zeros", 0)
            _check("table_sample_fwd",
                   f"pixelnerf level zeros {dt} 3 x {n_rays} x {s} pts",
                   kernel(), plain(), kernel, plain, torch, results,
                   nbytes=(u.numel() * 4 + rows * 2048 * table.element_size()
                           + u.shape[1] * 3 * 512 * table.element_size()),
                   ops=2.0 * 3 * u.shape[1] * 2048,
                   library_fn=_grid_sample_fns(torch, 512, dt, u, hw,
                                               "zeros"))
        del table
    return results


# (rays, intervals a ray) of kernels E and E': a MipNeRF-360 training
# step's NeRF and proposal levels, and a 4096-ray render tile's
MIP_SHAPES = ((2048, 32), (2048, 64), (4096, 32), (4096, 64))


def _mip_args(torch, g, b, s):
    """Seeded inputs of kernel E / E' for `b` rays of `s` intervals:
    density in [0, 10) (ray 0's first 1e30, so its acc is exactly 1),
    ascending tdist (B, S+1) in [0.2, 3], unnormalized dirs, rgb."""
    dev = g.device
    t = 0.2 + 2.8 * torch.sort(torch.rand(b, s + 1, device=dev,
                                          generator=g), -1).values
    density = torch.rand(b, s, device=dev, generator=g) * 10
    density[0, 0] = 1e30
    return (density, t, torch.randn(b, 3, device=dev, generator=g),
            torch.rand(b, s, 3, device=dev, generator=g))


def _mip_ties(case, acc, ref_acc):
    """Print the rays at or near the tie of max(0, 1 - acc): acc exactly
    1, within 4 ulp of 1, and where the kernel's and the plain version's
    acc take different branches (E' takes its branch from E's acc; the
    branch shifts d density only by rounding, as sum_i w_i is 1)."""
    near = (1.0 - acc).abs() <= 4 * 1.1920929e-07
    branch = lambda a: (1.0 - a).sign()
    differ = int((branch(acc) != branch(ref_acc)).sum())
    print(f"[kernel] composite_mip {case}: acc == 1 on "
          f"{int((acc == 1.0).sum())} rays (plain {int((ref_acc == 1.0).sum())}"
          f"), within 4 ulp on {int(near.sum())}, other branch than the "
          f"plain version on {differ}")


# (rays, points a ray) of kernels D and D' on the baselines' paths
VANILLA_SHAPES = ((2048, 65), (2048, 193), (512, 65), (512, 129),
                  (256, 193), (256, 129))


def _vanilla_args(torch, g, b, s):
    """Seeded inputs of kernel D / D' for `b` rays of `s` points: t
    ascending in [0.2, 3], densities in [0, 10), unnormalized dirs."""
    dev = g.device
    t = 0.2 + 2.8 * torch.sort(torch.rand(b, s, device=dev, generator=g),
                               -1).values
    return (torch.rand(b, s, 3, device=dev, generator=g),
            torch.rand(b, s, 1, device=dev, generator=g) * 10, t,
            torch.randn(b, 3, device=dev, generator=g))


def _pixelnerf_uv(torch, view, n_rays, s):
    """uv (3, n_rays * s, 2) of a PixelNeRF level's points: `s` evenly
    spaced points in [0.02, 3] along each of `n_rays` consecutive rays of
    the view's middle rows, seen from its 3 source views with (f, -f) and
    scaled to the 120x160 latent, as PixelNeRF._latents computes them."""
    from neo360_tpu_torch.core import geometry, sampling
    from neo360_tpu_torch.nn.resnet import latent_scaling
    start = 120 * 320
    rays_o = view["rays_o"][start:start + n_rays]
    rays_d = view["rays_d"][start:start + n_rays]
    _, pts = sampling.sample_along_rays(rays_o, rays_d, s - 1, 0.02, 3.0)
    cam = geometry.world2camera(pts.reshape(1, -1, 3), view["src_poses"],
                                ns=3)
    focal = view["src_focal"]
    uv = geometry.projection(cam, torch.stack([focal[0], -focal[0]])[None],
                             view["src_c"][:1], 3)
    scale = latent_scaling((120, 160), cam.device) / torch.tensor(
        [320.0, 240.0], device=cam.device)
    return (uv * scale - 1.0).contiguous()


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


def _fixture_view(torch, dev="cuda"):
    """One 320x240 fixture view of a seeded in-memory scene, as tensors on
    `dev`: its rays and its 3 source views' poses, focal and centre."""
    from neo360_tpu_torch.data.fixtures import MemoryScenes
    sample = MemoryScenes(1, (320, 240), 3).sample_test(0, 0)
    return {k: torch.as_tensor(v, device=dev) for k, v in sample.items()
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
    from neo360_tpu_torch.core.render import MIP_BACKWARD_TOL as E_TOL
    from neo360_tpu_torch.core.render import OUT_KEYS, composite_mip, \
        composite_mip_backward, composite_mip_reference, \
        composite_nerfpp_backward, composite_nerfpp_reference, \
        composite_vanilla_backward, composite_vanilla_reference
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

    # D': the baselines' training levels; the loss reads rgb alone
    for b, s in VANILLA_SHAPES[:4]:
        args = _vanilla_args(torch, g, b, s)
        grads = [torch.randn(b, 3, device=dev, generator=g), None, None,
                 None]
        leaves = [a.detach().requires_grad_(i < 2)
                  for i, a in enumerate(args)]
        comp = composite_vanilla_reference(*leaves, False)[0]
        plain = lambda: torch.autograd.grad(comp, leaves[:2], grads[0],
                                            retain_graph=True)
        kernel = lambda: composite_vanilla_backward(args, grads, False)
        # per sample: rgb, sigma, t read, d rgb and d sigma written; per
        # ray: dirs and the rgb cotangent read
        _check("composite_vanilla_bwd", f"B={b} S={s}", list(kernel()),
               list(plain()), kernel, plain, torch, results, B_TOL,
               nbytes=4.0 * b * (9 * s + 6), ops=40.0 * b * s,
               main=(b, s) == (2048, 193))

    # E': a training step's NeRF level (2048 x 32: the loss's rgb and the
    # distortion's and interlevel bound's weights cotangents), a proposal
    # level (2048 x 64: weights alone) and a 4096-ray tile with every
    # cotangent; E' takes the background's branch from E's acc
    for (b, s), keys in (((2048, 32), ("weights", "rgb")),
                         ((2048, 64), ("weights",)),
                         ((4096, 64), ("weights", "rgb", "acc", "depth"))):
        args = _mip_args(torch, g, b, s)
        shapes = ((b, s), (b, 3), (b,), (b,))
        grads = [torch.randn(sh, device=dev, generator=g) if k in keys
                 else None for k, sh in zip(("weights", "rgb", "acc",
                                             "depth"), shapes)]
        with torch.no_grad():
            acc = composite_mip(*args, 1.0, True)[2]
        leaves = [a.detach().requires_grad_(i in (0, 3))
                  for i, a in enumerate(args)]
        outs = composite_mip_reference(*leaves, 1.0, True)
        pairs = [(o, c) for o, c in zip(outs, grads) if c is not None]
        plain = lambda: [x if x is not None else torch.zeros_like(l)
                         for x, l in zip(torch.autograd.grad(
                             [o for o, _ in pairs], [leaves[0], leaves[3]],
                             [c for _, c in pairs], retain_graph=True,
                             allow_unused=True), (leaves[0], leaves[3]))]
        kernel = lambda: composite_mip_backward(args, acc, grads, 1.0, True)
        out = list(kernel())
        if not bool((out[0][:, -1] == 0).all()):
            raise AssertionError("composite_mip_bwd: the infinite last "
                                 "interval's density took a gradient")
        n_cot = sum(c.numel() for c in grads if c is not None)
        # per interval: density, tdist, rgb read, d density and d rgb
        # written; per ray: dirs and acc read; the cotangents read
        _check("composite_mip_bwd", f"B={b} S={s} cotangents {keys}", out,
               plain(), kernel, plain, torch, results, E_TOL,
               nbytes=4.0 * (b * (9 * s + 5) + n_cot), ops=30.0 * b * s,
               main=(b, s) == (2048, 32))

    # A', dense contract, at a PixelNeRF step's fine level (f32 table)
    shape = (3, 121, 161, 2048)
    u = _pixelnerf_uv(torch, _fixture_view(torch), 512, 129)
    cot = torch.randn(3, u.shape[1], 512, device=dev, generator=g)
    t32 = torch.zeros(shape, device=dev, requires_grad=True)
    fwd = table_sample_reference(t32, u, hw, "zeros", f32)
    plain = lambda: torch.autograd.grad(fwd, t32, cot, retain_graph=True)[0]
    kernel = lambda: table_sample_backward(cot, u, shape, f32, hw, "zeros")
    _check("table_sample_bwd", "dense pixelnerf level zeros f32 cotangent",
           kernel(), plain(), kernel, plain, torch, results, A_TOL,
           nbytes=cot.numel() * 4 + u.numel() * 4 + t32.numel() * 4,
           ops=2.0 * cot.numel() * 4,
           library_fn=_grid_sample_fns(torch, 512, f32, u, hw, "zeros", cot))
    del fwd, t32, cot, u
    return results


def phase_small_train(torch, **knobs):
    """One tiny f32 stage (K=2, S=2, deterministic sampling) on the card
    (kernels) against the same stage on the CPU (plain versions); `knobs`:
    Config width fields (plane_dim, local_proj_dim, pillar_width,
    depth_fc_layers) for a narrowed model.

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

    cfg = _tiny_cfg(seed=SEED, stage_k=2, ray_batch_size=32, **knobs)
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
    print(f"[small-train] K=2 S=2 f32 stage {knobs or ''}, card vs CPU: "
          f"gradients max "
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

        _zero(fns)
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
    missing = [k for k, n in launches.items()
               if n == 0 and not k.startswith(("composite_vanilla",
                                                "composite_mip"))]
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


def _syncs(torch, fn):
    """fn() under sync debug mode "warn": (the synchronising CUDA calls it
    warned of, the constants it built, the constants it was served)."""
    import warnings

    from neo360_tpu_torch.train import profiling
    before = profiling.constant_counts()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    after = profiling.constant_counts()
    return (sum("synchroniz" in str(w.message) for w in seen),
            after["builds"] - before["builds"],
            after["hits"] - before["hits"])


def phase_sync(torch):
    """One tiny float32 neo360 render tile (256 rays, the scene encoded
    beforehand) and one per-step training step with its optimizer, each
    twice: the second call must neither wait for the stream nor build a
    constant. One "[sync]" line a kind."""
    import numpy as np

    from neo360_tpu_torch import cli
    from neo360_tpu_torch.config import preset
    from neo360_tpu_torch.data.fixtures import MemoryScenes
    from neo360_tpu_torch.models.neo360 import RAY_KEYS, SRC_KEYS
    from neo360_tpu_torch.train import loop

    dev = torch.device("cuda")
    cfg = preset("neo360", seed=SEED, grid_size=(8, 8, 40), encoder_width=64,
                 num_coarse_samples=8, num_fine_samples=6, img_wh=(40, 30),
                 ray_batch_size=32)
    cli.float32_matmuls(cfg, dev)
    model = cli.build_model(cfg, dev).eval()
    batch = {k: torch.as_tensor(v, device=dev) for k, v in MemoryScenes(
        2, cfg.img_wh, 3, split="train", ray_batch_size=cfg.ray_batch_size
    ).sample_train(np.random.default_rng(SEED)).items()
        if k in cli.STEP_KEYS}
    src = {k: batch[k] for k in SRC_KEYS}
    with torch.inference_mode():
        enc = model.encode(*(src[k] for k in SRC_KEYS), False)

    def chunk(pack, rays):
        out = model(dict(rays, **src), pack, cfg.white_back,
                    out_depth=True)[1]
        return {"rgb": out["rgb"], "depth": out["depth"]}

    render = loop.make_image_renderer(chunk, cfg.chunk)
    rays = {k: batch[k][:1].expand(cfg.chunk, 3).contiguous()
            for k in RAY_KEYS}
    tile = [_syncs(torch, lambda: render(enc, rays)) for _ in range(2)]
    model.train()
    state = loop.create_train_state(
        model, lambda params: cli.build_optimizer(cfg, params))
    train_step = loop.make_train_step(cli.make_loss_fn(cfg, model),
                                      with_model_state=True)
    gen = torch.Generator(dev).manual_seed(SEED)
    step = [_syncs(torch, lambda: train_step(state, batch, gen))
            for _ in range(2)]
    for kind, (first, second) in (("render tile", tile),
                                  ("training step", step)):
        print(f"[sync] neo360 {kind}: first call {first[0]} syncs, "
              f"{first[1]} constants built, {first[2]} served; second "
              f"call {second[0]} syncs, {second[1]} built, {second[2]} "
              f"served")
        if second[0] or second[1]:
            raise AssertionError(f"a second neo360 {kind} waited for the "
                                 f"stream or built a constant")


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
            "pillar_collapse_fwd": 1, "pillar_collapse_bwd": 1,
            "composite_vanilla_fwd": 0, "composite_vanilla_bwd": 0,
            "composite_mip_fwd": 0, "composite_mip_bwd": 0}


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

        _zero(fns)
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
    _zero(fns)
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
            "pillar_collapse_fwd": 1, "pillar_collapse_bwd": 1,
            "composite_vanilla_fwd": 0, "composite_vanilla_bwd": 0,
            "composite_mip_fwd": 0, "composite_mip_bwd": 0}


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

            _zero(fns)
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
    from neo360_tpu_torch.data.fixtures import MemoryScenes
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

    counted = ("table_sample_fwd", "triplane_sample_fwd", "local_sample_fwd",
               "composite_nerfpp_fwd", "pillar_collapse_fwd")
    _zero(counted)
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


# the baselines' phases: vanilla trains VAN_STEPS steps in calls of
# VAN_CALL through cli.run_train, then run_eval renders the scene's 2 test
# views (full_eval) and, with vis_only, the views and VIS_FRAMES spiral
# frames; PixelNeRF trains PIX_STEPS steps, one a call, then renders 2
# test views of one scene (the second with the encode cached)
VAN_STEPS, VAN_CALL, VIS_FRAMES = 20, 10, 3
PIX_STEPS = 10


def _baseline_step_launches(exp_type: str) -> dict:
    """Kernel launches of one training step of a baseline, from the code:
    both levels composite with kernel D and back with D'; PixelNeRF also
    samples its latent table once per level (A, all views in one launch)
    and scatters each level's cotangent into a table-shaped gradient (A',
    dense contract); MipNeRF-360's three levels composite with kernel E
    and back with E' instead. No other kernel of the port."""
    out = {k: 0 for k in KERNELS}
    out["table_sample_bwd_acc"] = 0
    if exp_type == "mipnerf360":
        out.update(composite_mip_fwd=3, composite_mip_bwd=3)
        return out
    out.update(composite_vanilla_fwd=2, composite_vanilla_bwd=2)
    if exp_type == "pixelnerf":
        out.update(table_sample_fwd=2, table_sample_bwd=2)
    return out


def _baseline_view_launches(exp_type: str, tiles: int) -> dict:
    """Kernel launches of one rendered view of a baseline: both levels of
    every tile composite (D); PixelNeRF samples its table per level too
    (A); MipNeRF-360's three levels of every tile composite with E."""
    out = {k: 0 for k in KERNELS}
    out["table_sample_bwd_acc"] = 0
    if exp_type == "mipnerf360":
        out["composite_mip_fwd"] = 3 * tiles
        return out
    out["composite_vanilla_fwd"] = 2 * tiles
    if exp_type == "pixelnerf":
        out["table_sample_fwd"] = 2 * tiles
    return out


def _counting(fns, per, seconds, profile_at=None, label=""):
    """Wrap a function so that each call's launches (a dict per call in
    `per`) and seconds (host clock around a synchronized call) are
    recorded; call number `profile_at` runs under torch.profiler
    instead of being timed."""
    import torch

    def wrap(fn):
        def run(*args, **kw):
            start = _read(fns)
            if len(per) == profile_at:
                box = []
                _profile(torch, lambda: box.append(fn(*args, **kw)), label)
                out = box[0]
            else:
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t)
            end = _read(fns)
            per.append({k: end[k] - start[k] for k in end})
            return out
        return run
    return wrap


def _counted_renders(cli, fns, per_view, seconds, img_wh):
    """A make_render_fn whose render functions record each view's
    launches and seconds and check its outputs: one value per ray,
    finite."""
    plain = cli.make_render_fn
    n = img_wh[0] * img_wh[1]

    def make(*args, **kw):
        render = _counting(fns, per_view, seconds)(plain(*args, **kw))

        def checked(sample):
            out = render(sample)
            for k, v in out.items():
                if v.shape[0] != n or not bool(v.isfinite().all()):
                    raise AssertionError(f"render output {k}: shape "
                                         f"{tuple(v.shape)} or non-finite")
            return out
        return checked
    return make


def phase_vanilla_main_path(torch):
    """The vanilla NeRF at full width (8 x 256 MLP, 64 + 128 samples,
    float32, TF32 off) on a 320x240 micro scene that the port's own
    `make_micro_scene` writes under a temp dir: `cli.run_train` with the
    ray-buffer trainer, VAN_STEPS steps of 2048 rays in calls of VAN_CALL
    (the last step under torch.profiler), its validation render and
    checkpoint; then `cli.run_eval` full_eval of the scene's 2 test views
    and vis_only with VIS_FRAMES spiral frames. Every step launches
    exactly `_baseline_step_launches("vanilla")`, every view and frame
    `_baseline_view_launches`, every loss and metric is finite and the
    flythrough is written. Returns the path's launches, per step and per
    view."""
    import numpy as np

    from neo360_tpu_torch import cli
    from neo360_tpu_torch.config import preset
    from neo360_tpu_torch.data.fixtures import make_micro_scene
    from neo360_tpu_torch.train import loop

    fns = counters()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = make_micro_scene(os.path.join(tmp, "scene"), n_val=2,
                                wh=(320, 240))
        print(f"[vanilla] make_micro_scene wrote a 320x240 scene (103 train "
              f"+ 2 test views) in {time.perf_counter() - t0:.1f} s")
        cfg = preset("vanilla", root_dir=root, seed=SEED,
                     run_max_steps=VAN_STEPS, steps_per_call=VAN_CALL,
                     save_every_steps=VAN_STEPS, ckpt_dir=tmp, device="cuda")
        print(f"[vanilla] img_wh {cfg.img_wh}, batch {cfg.batch_size} rays, "
              f"64 + 128 samples, 8 x 256 MLP, float32, {VAN_STEPS} steps "
              f"in calls of {VAN_CALL}, chunk {cfg.chunk}")
        per_step, step_s, losses = [], [], []
        plain_step = loop.make_train_step

        def counted_step(loss_fn, **kw):
            step = _counting(fns, per_step, step_s, VAN_STEPS - 1,
                             "vanilla training step (2048 rays)")(
                plain_step(loss_fn, **kw))

            def run(*args):
                metrics = step(*args)
                losses.append(float(metrics["loss"]))
                return metrics
            return run

        _zero(fns)
        torch.cuda.reset_peak_memory_stats()
        loop.make_train_step = counted_step
        try:
            t0 = time.perf_counter()
            state = cli.run_train(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            loop.make_train_step = plain_step
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        train_launches = _read(fns)
        exp = os.path.join(tmp, "exp")
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        ckpts = sorted(os.listdir(os.path.join(exp, "checkpoints")))

        per_view, view_s = [], []
        plain_render = cli.make_render_fn
        cli.make_render_fn = _counted_renders(cli, fns, per_view, view_s,
                                              cfg.img_wh)
        try:
            summary = cli.run_eval(cfg.replace(eval_mode="full_eval"))
            cli.run_eval(cfg.replace(eval_mode="vis_only"),
                         n_frames=VIS_FRAMES)
        finally:
            cli.make_render_fn = plain_render
        outputs = sorted(os.listdir(os.path.join(exp, cfg.render_name)))
        launches = _read(fns)

    steady = statistics.median(step_s[1:])
    print(f"[vanilla] s/step: first {step_s[0]:.4f} (warm-up), steady "
          f"median {steady:.4f} (min {min(step_s[1:]):.4f}, max "
          f"{max(step_s[1:]):.4f}), {cfg.batch_size / steady:.0f} train "
          f"rays/s; peak device memory {peak:.2f} GiB; run_train wall "
          f"{wall:.2f} s (ray buffers, {VAN_STEPS} steps, validation "
          f"render, checkpoint)")
    print(f"[vanilla] losses first {losses[0]:.4f} last {losses[-1]:.4f}; "
          f"metrics.jsonl {records}; checkpoints {ckpts}")
    print(f"[vanilla] run_eval: {len(per_view)} renders (2 full_eval, 2 + "
          f"{VIS_FRAMES} vis_only), s/view {[round(x, 3) for x in view_s]}; "
          f"summary {summary}; outputs {outputs}")
    want = _baseline_step_launches("vanilla")
    tiles = -(-cfg.img_wh[0] * cfg.img_wh[1] // cfg.chunk)
    want_view = _baseline_view_launches("vanilla", tiles)
    print(f"[vanilla] launches per step {per_step[1]} (expected {want}); "
          f"per view {per_view[0]}")
    if len(losses) != VAN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"vanilla: losses {losses}")
    if state.step != VAN_STEPS or f"ckpt_{VAN_STEPS:08d}.pt" not in ckpts \
            or not any(np.isfinite(r.get("val_psnr", np.nan))
                       for r in records):
        raise AssertionError("vanilla: run_train did not validate and "
                             "checkpoint")
    if any(n != want for n in per_step):
        raise AssertionError(f"vanilla: launches per step {per_step}")
    if len(per_view) != 4 + VIS_FRAMES or any(n != want_view
                                             for n in per_view):
        raise AssertionError(f"vanilla: launches per view {per_view}, "
                             f"expected {want_view}")
    if not (np.isfinite(summary["psnr"]) and np.isfinite(summary["ssim"])
            and any(o.startswith("video360.") for o in outputs)):
        raise AssertionError(f"vanilla: eval {summary}, outputs {outputs}")
    return launches, per_step, per_view, {"s_step": steady,
                                          "peak_gib": peak,
                                          "s_view": view_s}


def phase_pixelnerf_main_path(torch):
    """PixelNeRF at full width (ResNet34 SpatialEncoder, 4 x 128 MLP, 64 +
    64 samples, 3 source views, float32, TF32 off) on 3 in-memory 320x240
    fixture scenes: `cli.run_train` with the per-step trainer, PIX_STEPS
    calls of one 512-ray step (the last under torch.profiler), its
    validation render and checkpoint; then the trained model renders 2
    test views of one scene through cli.make_render_fn (the encode
    once). Every step launches exactly `_baseline_step_launches
    ("pixelnerf")` and every view `_baseline_view_launches`, every loss is
    finite and every BatchNorm buffer moves. Returns the path's launches,
    per step and per view."""
    import numpy as np

    from neo360_tpu_torch import cli
    from neo360_tpu_torch.config import preset
    from neo360_tpu_torch.data.fixtures import MemoryScenes
    from neo360_tpu_torch.train import loop
    from neo360_tpu_torch.train.eval import evaluate

    fns = counters()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = preset("pixelnerf", seed=SEED, ray_batch_size=512,
                     run_max_steps=PIX_STEPS, steps_per_call=1,
                     log_every_steps=1, save_every_steps=PIX_STEPS,
                     ckpt_dir=tmp, device="cuda")
        print(f"[pixelnerf] img_wh {cfg.img_wh}, {cfg.num_src_views} source "
              f"views, {cfg.ray_batch_size} rays/step, 64 + 64 samples, "
              f"bf16 {cfg.bf16}, {PIX_STEPS} steps, chunk {cfg.chunk}")
        datasets = tuple(MemoryScenes(3, cfg.img_wh, cfg.num_src_views,
                                      split=split,
                                      ray_batch_size=cfg.ray_batch_size)
                         for split in ("train", "val"))
        before = {k: v.clone() for k, v in cli.build_model(
            cfg, "cpu").state_dict().items() if "running" in k}
        per_step, step_s, losses = [], [], []
        plain_factory = loop.make_staged_trainer

        def counted_factory(step_fn):
            run = _counting(fns, per_step, step_s, PIX_STEPS - 1,
                            "pixelnerf training step (512 rays)")(
                plain_factory(step_fn))

            def staged(*args):
                metrics = run(*args)
                losses.append(float(metrics["loss"]))
                return metrics
            return staged

        _zero(fns)
        torch.cuda.reset_peak_memory_stats()
        loop.make_staged_trainer = counted_factory
        try:
            t0 = time.perf_counter()
            state = cli.run_train(cfg, datasets=datasets)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            loop.make_staged_trainer = plain_factory
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ckpts = sorted(os.listdir(os.path.join(tmp, "exp", "checkpoints")))

    model = state.model.eval()
    after = {k: v.cpu() for k, v in model.state_dict().items()
             if "running" in k}
    unmoved = [k for k in before if torch.equal(before[k], after[k])]
    encodes = []
    plain_encode = model.encode

    def counted_encode(*args, **kw):
        encodes.append(1)
        return plain_encode(*args, **kw)

    model.encode = counted_encode
    per_view, view_s = [], []
    render_fn = _counted_renders(cli, fns, per_view, view_s, cfg.img_wh)(
        cfg, model)
    scenes = MemoryScenes(1, cfg.img_wh, cfg.num_src_views)
    samples = [dict(scenes.sample_test(0, d), scene_key=0) for d in range(2)]
    views = list(evaluate(render_fn, samples, cfg.img_wh))
    del model.encode
    launches = _read(fns)

    steady = statistics.median(step_s[1:])
    print(f"[pixelnerf] s/step: first {step_s[0]:.4f} (warm-up), steady "
          f"median {steady:.4f} (min {min(step_s[1:]):.4f}, max "
          f"{max(step_s[1:]):.4f}), {cfg.ray_batch_size / steady:.0f} train "
          f"rays/s; peak device memory {peak:.2f} GiB; run_train wall "
          f"{wall:.2f} s; losses first {losses[0]:.4f} last "
          f"{losses[-1]:.4f}; checkpoints {ckpts}; BatchNorm buffers "
          f"unmoved {len(unmoved)} / {len(before)}")
    print(f"[pixelnerf] views: s/view {[round(x, 3) for x in view_s]} "
          f"(view 0 with the encode), PSNR / SSIM "
          f"{[(round(v.psnr, 3), round(v.ssim, 4)) for v in views]}, "
          f"encodes {len(encodes)}")
    want = _baseline_step_launches("pixelnerf")
    tiles = -(-cfg.img_wh[0] * cfg.img_wh[1] // cfg.chunk)
    want_view = _baseline_view_launches("pixelnerf", tiles)
    print(f"[pixelnerf] launches per step {per_step[1]} (expected {want}); "
          f"per view {per_view}")
    if len(losses) != PIX_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"pixelnerf: losses {losses}")
    if state.step != PIX_STEPS or f"ckpt_{PIX_STEPS:08d}.pt" not in ckpts:
        raise AssertionError("pixelnerf: no checkpoint")
    if unmoved:
        raise AssertionError(f"pixelnerf: BatchNorm buffers did not move: "
                             f"{unmoved[:5]}")
    if any(n != want for n in per_step):
        raise AssertionError(f"pixelnerf: launches per step {per_step}")
    if per_view != [want_view] * 2 or len(encodes) != 1:
        raise AssertionError(f"pixelnerf: launches per view {per_view} "
                             f"(expected {want_view}), encodes {encodes}")
    if not all(np.isfinite(v.psnr) and np.isfinite(v.rgb).all()
               for v in views):
        raise AssertionError("pixelnerf: non-finite render")
    return launches, per_step, per_view, {"s_step": steady,
                                          "peak_gib": peak,
                                          "s_view": view_s}


# the MipNeRF-360 phase: MIP_STEPS steps in calls of MIP_CALL through
# cli.run_train, then run_eval renders the scene's 2 test views (full_eval)
# and, with vis_only, the views and VIS_FRAMES spiral frames, in 4096-ray
# tiles
MIP_STEPS, MIP_CALL, MIP_CHUNK = 20, 10, 4096


def phase_mipnerf360_main_path(torch):
    """MipNeRF-360 at full width (8 x 1024 NeRF MLP, two 4 x 256 proposal
    MLPs, 64 + 64 + 32 samples, lifted IPE, float32, TF32 off) on a
    320x240 micro scene that the port's `make_micro_scene` writes under a
    temp dir: `cli.run_train` with the ray-buffer trainer, MIP_STEPS
    steps of 2048 rays in calls of MIP_CALL (the last step under
    torch.profiler), its validation render and checkpoint; then
    `cli.run_eval` full_eval of the scene's 2 test views and vis_only with
    VIS_FRAMES spiral frames at --chunk MIP_CHUNK; one tile of the trained
    model under torch.profiler. Every step launches exactly
    `_baseline_step_launches("mipnerf360")` (E and E' 3 times), every
    view and frame `_baseline_view_launches` (E 3 times a tile), the tile
    E 3 times; every loss and metric is finite and the flythrough is
    written. Returns the path's launches, per step and per view."""
    import numpy as np

    from neo360_tpu_torch import cli
    from neo360_tpu_torch.config import preset
    from neo360_tpu_torch.data.fixtures import make_micro_scene
    from neo360_tpu_torch.data.nerds360 import NeRDS360
    from neo360_tpu_torch.train import loop

    fns = counters()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = make_micro_scene(os.path.join(tmp, "scene"), n_val=2,
                                wh=(320, 240))
        print(f"[mip] make_micro_scene wrote a 320x240 scene (103 train + 2 "
              f"test views) in {time.perf_counter() - t0:.1f} s")
        cfg = preset("mipnerf360", root_dir=root, seed=SEED,
                     run_max_steps=MIP_STEPS, steps_per_call=MIP_CALL,
                     save_every_steps=MIP_STEPS, chunk=MIP_CHUNK,
                     ckpt_dir=tmp, device="cuda")
        print(f"[mip] img_wh {cfg.img_wh}, batch {cfg.batch_size} rays, 64 + "
              f"64 + 32 samples, 8 x 1024 NeRF MLP, 2 x (4 x 256) proposal "
              f"MLPs, float32, {MIP_STEPS} steps in calls of {MIP_CALL}, "
              f"chunk {cfg.chunk}")
        per_step, step_s, losses = [], [], []
        plain_step = loop.make_train_step

        def counted_step(loss_fn, **kw):
            step = _counting(fns, per_step, step_s, MIP_STEPS - 1,
                             "mipnerf360 training step (2048 rays)")(
                plain_step(loss_fn, **kw))

            def run(*args):
                metrics = step(*args)
                losses.append(float(metrics["loss"]))
                return metrics
            return run

        _zero(fns)
        torch.cuda.reset_peak_memory_stats()
        loop.make_train_step = counted_step
        try:
            t0 = time.perf_counter()
            state = cli.run_train(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            loop.make_train_step = plain_step
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        exp = os.path.join(tmp, "exp")
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        ckpts = sorted(os.listdir(os.path.join(exp, "checkpoints")))

        per_view, view_s = [], []
        plain_render = cli.make_render_fn
        cli.make_render_fn = _counted_renders(cli, fns, per_view, view_s,
                                              cfg.img_wh)
        torch.cuda.reset_peak_memory_stats()
        try:
            summary = cli.run_eval(cfg.replace(eval_mode="full_eval"))
            cli.run_eval(cfg.replace(eval_mode="vis_only"),
                         n_frames=VIS_FRAMES)
        finally:
            cli.make_render_fn = plain_render
        eval_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        outputs = sorted(os.listdir(os.path.join(exp, cfg.render_name)))
        launches = _read(fns)

        # one tile of the trained model, profiled and counted on its own
        view = NeRDS360(root, "test", cfg.img_wh).image_rays(0)
        tile = {k: v[:MIP_CHUNK] for k, v in view.items()}
        render_fn = cli.make_render_fn(cfg, state.model.eval(), "cuda")
        render_fn(tile)
        start = _read(fns)
        _profile(torch, lambda: render_fn(tile),
                 f"mipnerf360 render tile ({MIP_CHUNK} rays)")
        per_tile = {k: n - start[k] for k, n in _read(fns).items()}

    steady = statistics.median(step_s[1:])
    print(f"[mip] s/step: first {step_s[0]:.4f} (warm-up), steady median "
          f"{steady:.4f} (min {min(step_s[1:]):.4f}, max "
          f"{max(step_s[1:]):.4f}), {cfg.batch_size / steady:.0f} train "
          f"rays/s; peak device memory {peak:.2f} GiB in training, "
          f"{eval_peak:.2f} GiB in eval; run_train wall {wall:.2f} s (ray "
          f"buffers, {MIP_STEPS} steps, validation render, checkpoint)")
    print(f"[mip] losses first {losses[0]:.4f} last {losses[-1]:.4f}; "
          f"metrics.jsonl {records}; checkpoints {ckpts}")
    print(f"[mip] run_eval: {len(per_view)} renders (2 full_eval, 2 + "
          f"{VIS_FRAMES} vis_only), s/view {[round(x, 3) for x in view_s]}; "
          f"summary {summary}; outputs {outputs}")
    want = _baseline_step_launches("mipnerf360")
    tiles = -(-cfg.img_wh[0] * cfg.img_wh[1] // cfg.chunk)
    want_view = _baseline_view_launches("mipnerf360", tiles)
    want_tile = _baseline_view_launches("mipnerf360", 1)
    print(f"[mip] launches per step {per_step[1]} (expected {want}); per "
          f"view {per_view[0]}; per tile {per_tile}")
    if len(losses) != MIP_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"mipnerf360: losses {losses}")
    if state.step != MIP_STEPS or f"ckpt_{MIP_STEPS:08d}.pt" not in ckpts \
            or not any(np.isfinite(r.get("val_psnr", np.nan))
                       for r in records):
        raise AssertionError("mipnerf360: run_train did not validate and "
                             "checkpoint")
    if any(n != want for n in per_step):
        raise AssertionError(f"mipnerf360: launches per step {per_step}")
    if len(per_view) != 4 + VIS_FRAMES or any(n != want_view
                                             for n in per_view):
        raise AssertionError(f"mipnerf360: launches per view {per_view}, "
                             f"expected {want_view}")
    if per_tile != want_tile:
        raise AssertionError(f"mipnerf360: launches per tile {per_tile}, "
                             f"expected {want_tile}")
    if not (np.isfinite(summary["psnr"]) and np.isfinite(summary["ssim"])
            and any(o.startswith("video360.") for o in outputs)):
        raise AssertionError(f"mipnerf360: eval {summary}, outputs "
                             f"{outputs}")
    return launches, per_step, per_view, {"s_step": steady,
                                          "peak_gib": peak,
                                          "s_view": view_s}


# the data-parallel phase: DP_RANKS ranks share the card over gloo (NCCL
# refuses two ranks on one device) and run what one rank runs in this
# process from the same seed: DP_STAGES neo360_fast stages through
# cli.run_train and full_eval of DP_VIEWS views, DP_MIP_STEPS MipNeRF-360
# steps and one LPIPS-finetune step; one NCCL rank runs one stage.
DP_RANKS, DP_STAGES, DP_VIEWS, DP_MIP_STEPS = 2, 2, 3, 3
# Bounds. A' adds with float atomics, so two one-rank runs of the same
# seed differ; the ranks' runs are held to that spread: their parameters
# and buffers, and their renders, within DP_SPREAD_MULTIPLE times the
# largest difference between two one-rank runs. The first step's reduced
# gradient against the one-rank gradient, relative to its largest entry:
# DP_GRAD_RTOL_F32 in float32 (MipNeRF-360: the halves' GEMMs round in
# their own order) and DP_GRAD_RTOL_BF16 with bf16 compute (the
# finetune).
DP_SPREAD_MULTIPLE = 10.0
DP_GRAD_RTOL_F32, DP_GRAD_RTOL_BF16 = 1e-4, 3e-2


def _files(path: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, fs in os.walk(path) for f in fs)


def _rank_dir(cfg):
    """`cfg` with its ckpt_dir under rank<r>/ in a data-parallel group, so
    a file there is a file that rank wrote."""
    from neo360_tpu_torch.parallel import sharding
    group = sharding.current()
    if group is None:
        return cfg
    return cfg.replace(ckpt_dir=os.path.join(cfg.ckpt_dir,
                                             f"rank{group.rank}"))


def _dp_fast(cfg, eval_ckpt=None):
    """neo360_fast through `cli.run_train(cfg)` on 3 in-memory scenes, one
    stage a call; with `eval_ckpt`, `cli.run_eval` full_eval of DP_VIEWS
    views of one in-memory scene from that checkpoint. Runs in a
    data-parallel rank or, as the one-rank reference, in this process.
    Returns host data: the state dict, each stage's launches, seconds and
    gradient reductions, the peak memory, the backend, each view's
    launches and rgb, the eval summary and the files under the
    ckpt_dir."""
    import torch

    from neo360_tpu_torch import cli
    from neo360_tpu_torch.data.fixtures import MemoryScenes
    from neo360_tpu_torch.parallel import sharding
    from neo360_tpu_torch.train import loop

    cfg = _rank_dir(cfg)
    fns = counters()
    _zero(fns)
    group = sharding.current()
    out = {"per_stage": [], "seconds": [], "reductions": [],
           "backend": None if group is None else
           torch.distributed.get_backend()}
    reductions = []
    plain_factory, plain_reduce = (loop.make_scene_stage_trainer,
                                   sharding.all_reduce_mean_)

    def counted_reduce(tensors, group):
        reductions.append(len(tensors))
        plain_reduce(tensors, group)

    def timed_factory(*a, **kw):
        run = plain_factory(*a, **kw)

        def timed(*args):
            start, n_red = _read(fns), len(reductions)
            torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = run(*args)
            torch.cuda.synchronize()
            out["seconds"].append(time.perf_counter() - t)
            end = _read(fns)
            out["per_stage"].append({k: end[k] - start[k] for k in end})
            out["reductions"].append(len(reductions) - n_red)
            return metrics
        return timed

    datasets = tuple(MemoryScenes(3, cfg.img_wh, cfg.num_src_views,
                                  split=split,
                                  ray_batch_size=cfg.ray_batch_size)
                     for split in ("train", "val"))
    torch.cuda.reset_peak_memory_stats()
    loop.make_scene_stage_trainer = timed_factory
    sharding.all_reduce_mean_ = counted_reduce
    try:
        state = cli.run_train(cfg, datasets=datasets)
        torch.cuda.synchronize()
    finally:
        loop.make_scene_stage_trainer = plain_factory
        sharding.all_reduce_mean_ = plain_reduce
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["state"] = {k: v.detach().cpu()
                    for k, v in state.model.state_dict().items()}
    if eval_ckpt is not None:
        per_view, view_s, rgbs = [], [], []
        plain_render = cli.make_render_fn
        counted = _counted_renders(cli, fns, per_view, view_s, cfg.img_wh)

        def keeping(*a, **kw):
            render = counted(*a, **kw)

            def run(sample):
                rendered = render(sample)
                rgbs.append(rendered["rgb"].float().cpu())
                return rendered
            return run

        cli.make_render_fn = keeping
        try:
            out["summary"] = cli.run_eval(
                cfg.replace(eval_mode="full_eval", ckpt_path=eval_ckpt),
                dataset=MemoryScenes(1, cfg.img_wh, cfg.num_src_views,
                                     n_val=DP_VIEWS))
        finally:
            cli.make_render_fn = plain_render
        out.update(per_view=per_view, view_s=view_s, rgb=rgbs)
    out["files"] = _files(cfg.ckpt_dir)
    return out


def _first_step_grads(box: list):
    """Adam.step recording the gradients of its first call in `box` (on
    the host) before it clips and steps."""
    from neo360_tpu_torch.train.optim import Adam
    plain = Adam.step

    def step(self, grads):
        if not box:
            box.append([g.detach().float().cpu().clone() for g in grads])
        return plain(self, grads)
    return step


def _dp_small(mip_cfg, ft_cfg):
    """MipNeRF-360's ray-buffer trainer for mip_cfg.run_max_steps steps,
    then one neo360_fast LPIPS-finetune step (its square patch gathered
    from the ranks before the LPIPS term) on 3 in-memory scenes, through
    `cli.run_train`. Runs in a data-parallel rank or, as the one-rank
    reference, in this process. Returns each run's per-step losses (the
    global batch's), its first step's gradients as the optimizer received
    them, its state dict and the files under its ckpt_dir."""
    import torch

    from neo360_tpu_torch import cli
    from neo360_tpu_torch.data.fixtures import MemoryScenes
    from neo360_tpu_torch.train import loop
    from neo360_tpu_torch.train.optim import Adam

    out = {}
    for name, cfg in (("mip", mip_cfg), ("finetune", ft_cfg)):
        cfg = _rank_dir(cfg)
        losses, grads = [], []
        plain_step, plain_adam = loop.make_train_step, Adam.step
        recording = _first_step_grads(grads)

        def counted_step(loss_fn, **kw):
            step = plain_step(loss_fn, **kw)

            def run(*args):
                metrics = step(*args)
                losses.append(float(metrics["loss"]))
                return metrics
            return run

        datasets = None
        if name == "finetune":
            datasets = (MemoryScenes(3, cfg.img_wh, cfg.num_src_views,
                                     split="train",
                                     ray_batch_size=cfg.ray_batch_size,
                                     finetune_lpips=True),
                        MemoryScenes(3, cfg.img_wh, cfg.num_src_views,
                                     split="val"))
        loop.make_train_step, Adam.step = counted_step, recording
        try:
            state = cli.run_train(cfg, datasets=datasets)
            torch.cuda.synchronize()
        finally:
            loop.make_train_step, Adam.step = plain_step, plain_adam
        out[name] = {"losses": losses, "grads": grads[0],
                     "state": {k: v.detach().cpu() for k, v in
                               state.model.state_dict().items()},
                     "files": _files(cfg.ckpt_dir)}
    return out


def _max_diff(a: dict, b: dict) -> tuple:
    """(largest |a - b| over the floating-point tensors of two state
    dicts, the key where it is)."""
    best = (0.0, None)
    for k, v in a.items():
        if v.is_floating_point():
            d = float((v.float() - b[k].float()).abs().max())
            best = max(best, (d, k), key=lambda x: x[0])
    return best


def _grad_rel(grads, ref) -> float:
    """Largest |grads - ref| over the largest |ref|, over all tensors."""
    scale = max(float(g.abs().max()) for g in ref)
    return max(float((g - r).abs().max()) for g, r in zip(grads, ref)) / \
        scale


def phase_data_parallel(torch, dev: str = "cuda", **small):
    """The data-parallel path on the card (parallel/sharding.py and the
    trainers' reductions), against one rank of the same seed:

    (a) neo360_fast at full width (`small` cuts it for a rehearsal
        elsewhere): DP_RANKS gloo ranks on the card run DP_STAGES stages
        of K=32, S=2, 500 rays (125 a scene and rank) through
        cli.run_train, then full_eval of DP_VIEWS views from rank 0's
        checkpoint; one rank in this process runs the same twice (the
        spread of two one-rank runs). Parameters and buffers, and the
        renders, lie within DP_SPREAD_MULTIPLE times that spread of the
        one-rank run; the ranks hold the same bits (every BatchNorm
        buffer too) and the same eval summary; each rank's launches per
        stage equal the one-rank counts, and its reductions per stage are
        K + 1 (every step's ray gradients, the stage's encoder gradient);
        per view each rank encodes once and renders half the tiles; rank
        1 writes no file, rank 0 writes the one-rank run's files.
    (b) one NCCL rank through the same code and the same stages, without
        the eval: the backend is NCCL (its gradient reductions, the
        checkpoint's barrier and the validation render's gather run
        through it), its launches and reductions are (a)'s, its
        parameters and buffers lie within (a)'s bound.
    (c) DP_RANKS gloo ranks: DP_MIP_STEPS MipNeRF-360 steps of 2048 rays
        (1024 a rank) on a 320x240 micro scene, and one finetune step
        (900-ray patch, 450 a rank, gathered for the LPIPS term) from
        (a)'s one-rank checkpoint: the losses and the first step's
        gradients against one rank (DP_GRAD_RTOL_*), the ranks equal.

    Every comparison is printed; the phase raises at its end if any
    failed. Returns the seconds, peak memory and differences it printed.
    The launches of this phase are not in the {"kernels": ...} line's
    totals (its ranks count in their own processes)."""
    import numpy as np

    from neo360_tpu_torch.config import preset
    from neo360_tpu_torch.data.fixtures import make_micro_scene
    from neo360_tpu_torch.nn.lpips import random_torch_state
    from neo360_tpu_torch.parallel import sharding

    failures = []

    def check(ok: bool, what: str):
        print(f"[dp] {'ok' if ok else 'FAILED'}: {what}")
        if not ok:
            failures.append(what)

    def launch(fn, *args, nccl: bool = False):
        """fn(*args) on DP_RANKS gloo ranks on the card (cuda:0), or on
        one rank of the default backend (NCCL on the card)."""
        if nccl:
            return sharding.launch(fn, 1, *args, device=dev)
        return sharding.launch(fn, DP_RANKS, *args, backend="gloo",
                               device=f"{dev}:0" if dev == "cuda" else dev)

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = preset("neo360_fast", seed=SEED, device=dev, **small)
        k = cfg.stage_k
        cfg = cfg.replace(run_max_steps=DP_STAGES * k, steps_per_call=k,
                          log_every_steps=k,
                          save_every_steps=DP_STAGES * k)
        ckpt = os.path.join("exp", "checkpoints",
                            f"ckpt_{DP_STAGES * k:08d}.pt")
        print(f"[dp] neo360_fast: img_wh {cfg.img_wh}, bf16 {cfg.bf16}, "
              f"K={k}, S={cfg.stage_scenes}, {cfg.ray_batch_size} rays a "
              f"step, {DP_STAGES} stages; {DP_RANKS} gloo ranks on {dev} "
              f"against one rank in this process, twice")
        runs = {}
        for name in ("one_a", "one_b"):
            d = os.path.join(tmp, name)
            t = time.perf_counter()
            runs[name] = _dp_fast(cfg.replace(ckpt_dir=d),
                                  os.path.join(d, ckpt))
            print(f"[dp] one rank ({name}): {time.perf_counter() - t:.1f} "
                  f"s for build, {DP_STAGES} stages, validation, "
                  f"checkpoint and {DP_VIEWS} views")
        d = os.path.join(tmp, "dp")
        t = time.perf_counter()
        ranks = launch(_dp_fast, cfg.replace(ckpt_dir=d),
                       os.path.join(d, "rank0", ckpt))
        print(f"[dp] {DP_RANKS} ranks: {time.perf_counter() - t:.1f} s for "
              f"start-up, build, {DP_STAGES} stages, validation, checkpoint "
              f"and {DP_VIEWS} views")
        one, other = runs["one_a"], runs["one_b"]

        spread, spread_key = _max_diff(other["state"], one["state"])
        diff, diff_key = _max_diff(ranks[0]["state"], one["state"])
        check(diff <= DP_SPREAD_MULTIPLE * spread,
              f"parameters and buffers: {DP_RANKS} ranks vs one rank max "
              f"|diff| {diff:.3e} ({diff_key}); one rank vs one rank "
              f"{spread:.3e} ({spread_key}); bound {DP_SPREAD_MULTIPLE} x "
              f"the spread")
        bn = [n for n in one["state"]
              if n.endswith(("running_mean", "running_var"))]
        same = [n for n in one["state"] if all(
            torch.equal(r["state"][n], ranks[0]["state"][n])
            for r in ranks[1:])]
        check(len(same) == len(one["state"]) and len(bn) > 0,
              f"ranks bit-equal: {len(same)} of {len(one['state'])} "
              f"tensors, {sum(n in same for n in bn)} of {len(bn)} "
              f"BatchNorm buffers")
        want = one["per_stage"]
        s, sk = cfg.stage_scenes, cfg.stage_scenes * k
        formula = {"table_sample_fwd": s, "pillar_collapse_fwd": s,
                   "pillar_collapse_bwd": s, "triplane_sample_fwd": sk,
                   "local_sample_fwd": sk, "table_sample_bwd": s,
                   "table_sample_bwd_acc": 4 * sk,
                   "composite_nerfpp_bwd": 2 * sk}
        check(all(st[n] == v for st in want for n, v in formula.items()),
              f"one rank's launches per stage {want[0]} give {formula}")
        for r, rank in enumerate(ranks):
            check(rank["per_stage"] == want,
                  f"rank {r} launches per stage equal one rank's: "
                  f"{rank['per_stage'] == want} ({rank['per_stage'][0]})")
            check(rank["reductions"] == [k + 1] * DP_STAGES
                  and one["reductions"] == [0] * DP_STAGES,
                  f"rank {r} gradient reductions per stage "
                  f"{rank['reductions']} (K + 1 = {k + 1}; one rank "
                  f"{one['reductions']})")
        per_view_one = one["per_view"]
        summed = [{n: sum(r["per_view"][v][n] for r in ranks)
                   for n in per_view_one[v]} for v in range(DP_VIEWS)]
        encode = ("table_sample_fwd", "pillar_collapse_fwd")
        check(all(summed[v][n] == per_view_one[v][n] * (
            DP_RANKS if n in encode else 1)
            for v in range(DP_VIEWS) for n in per_view_one[v])
            and all(r["per_view"][v][n] == per_view_one[v][n]
                    for r in ranks for v in range(DP_VIEWS)
                    for n in encode),
            f"launches per view: one rank {per_view_one}; each rank "
            f"{[r['per_view'] for r in ranks]} (each encodes, the tiles "
            f"split)")
        rgb_spread = max(float((a - b).abs().max())
                         for a, b in zip(other["rgb"], one["rgb"]))
        rgb_diff = max(float((a - b).abs().max())
                       for a, b in zip(ranks[0]["rgb"], one["rgb"]))
        agree = [float(-10 * np.log10(float(((a - b) ** 2).mean()) + 1e-20))
                 for a, b in zip(ranks[0]["rgb"], one["rgb"])]
        check(rgb_diff <= DP_SPREAD_MULTIPLE * rgb_spread,
              f"renders: {DP_RANKS} ranks vs one rank max |rgb diff| "
              f"{rgb_diff:.3e}, PSNR of one against the other {agree} dB; "
              f"one rank vs one rank {rgb_spread:.3e}; summaries: one rank "
              f"{one['summary']}, again {other['summary']}, ranks "
              f"{[r['summary'] for r in ranks]}")
        check(all(r["summary"] == ranks[0]["summary"] for r in ranks),
              "every rank returns the same eval summary")
        check(all(r["files"] == [] for r in ranks[1:])
              and ranks[0]["files"] == one["files"],
              f"files: rank 0 {len(ranks[0]['files'])} (one rank "
              f"{len(one['files'])}: {one['files']}), other ranks "
              f"{[r['files'] for r in ranks[1:]]}")
        print(f"[dp] s/stage (the first with warm-up): one rank "
              f"{one['seconds']}, again "
              f"{other['seconds']}; each of {DP_RANKS} ranks sharing one "
              f"card (correctness, not scaling) "
              f"{[r['seconds'] for r in ranks]}; peak GiB one rank "
              f"{one['peak_gib']:.2f}, ranks "
              f"{[round(r['peak_gib'], 2) for r in ranks]}; s/view one "
              f"rank {[round(x, 3) for x in one['view_s']]}, ranks "
              f"{[[round(x, 3) for x in r['view_s']] for r in ranks]}")

        # (b) one NCCL rank: the same run without the eval
        t = time.perf_counter()
        (nccl,) = launch(_dp_fast, cfg.replace(
            ckpt_dir=os.path.join(tmp, "nccl")), nccl=True)
        want_backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"
        nccl_diff, nccl_key = _max_diff(nccl["state"], one["state"])
        check(nccl["backend"] == want_backend and nccl["per_stage"] == want
              and nccl["reductions"] == [k + 1] * DP_STAGES
              and nccl_diff <= DP_SPREAD_MULTIPLE * spread,
              f"one {nccl['backend']} rank: launches per stage equal one "
              f"rank's: {nccl['per_stage'] == want}, reductions "
              f"{nccl['reductions']}, parameters and buffers vs one rank max "
              f"|diff| {nccl_diff:.3e} ({nccl_key}), s/stage "
              f"{nccl['seconds']}, peak {nccl['peak_gib']:.2f} GiB, "
              f"{time.perf_counter() - t:.1f} s with start-up, "
              f"build, validation and checkpoint")

        # (c) MipNeRF-360 and the finetune, DP_RANKS gloo ranks
        t = time.perf_counter()
        root = make_micro_scene(os.path.join(tmp, "scene"), n_val=1,
                                wh=cfg.img_wh)
        mip = preset("mipnerf360", root_dir=root, seed=SEED, device=dev,
                     run_max_steps=DP_MIP_STEPS, steps_per_call=DP_MIP_STEPS,
                     save_every_steps=10 ** 9, img_wh=cfg.img_wh)
        lpips = os.path.join(tmp, "lpips.pt")
        torch.save(random_torch_state(SEED), lpips)
        ft = cfg.replace(finetune_lpips=True, lpips_weights=lpips,
                         ckpt_path=os.path.join(tmp, "one_a", ckpt),
                         run_max_steps=1, steps_per_call=1,
                         save_every_steps=10 ** 9)
        small_one = _dp_small(mip.replace(ckpt_dir=os.path.join(tmp, "m1")),
                              ft.replace(ckpt_dir=os.path.join(tmp, "f1")))
        small_ranks = launch(_dp_small,
                             mip.replace(ckpt_dir=os.path.join(tmp, "m2")),
                             ft.replace(ckpt_dir=os.path.join(tmp, "f2")))
        for name, rtol in (("mip", DP_GRAD_RTOL_F32),
                           ("finetune", DP_GRAD_RTOL_BF16)):
            ref, got = small_one[name], [r[name] for r in small_ranks]
            rel = _grad_rel(got[0]["grads"], ref["grads"])
            loss_rel = max(abs(a - b) / abs(b) for a, b in
                           zip(got[0]["losses"], ref["losses"]))
            check(rel <= rtol and len(got[0]["losses"]) ==
                  len(ref["losses"]) and np.isfinite(ref["losses"]).all(),
                  f"{name}: first step's gradient, {DP_RANKS} ranks vs one "
                  f"rank, max |diff| / max |g| {rel:.3e} (bound {rtol}); "
                  f"losses {got[0]['losses']} vs {ref['losses']} (largest "
                  f"relative diff {loss_rel:.3e}); parameters max |diff| "
                  f"{_max_diff(got[0]['state'], ref['state'])[0]:.3e}")
            check(all(_max_diff(g["state"], got[0]["state"])[0] == 0
                      and g["losses"] == got[0]["losses"] for g in got)
                  and all(g["files"] == [] for g in got[1:]),
                  f"{name}: ranks bit-equal, rank 1 wrote no file")
        print(f"[dp] MipNeRF-360 and finetune, one rank and {DP_RANKS} "
              f"ranks: {time.perf_counter() - t:.1f} s")

    seconds = time.perf_counter() - t_phase
    print(f"[dp] phase: {seconds:.1f} s")
    if failures:
        raise AssertionError(f"data-parallel phase: {failures}")
    return {"seconds": seconds, "param_diff": diff, "param_spread": spread,
            "rgb_diff": rgb_diff, "rgb_spread": rgb_spread}


# the helpers' phase: grid_sample_2d at the plane-sweep warp's shape (32
# channels at a quarter of 320x240, WARP_DEPTHS hypothesis depths) and at
# an RGB image's (3 channels); TP_RANKS gloo ranks run the
# tensor-parallel NeRF MLP on the CPU: DTensor's all-gather of CUDA
# tensors through gloo (the only backend for two ranks on one card)
# segfaults in wait_tensor (torch 2.11.0+cu128, PERF.md section 6), where
# gloo's own all_gather of CUDA tensors works
WARP_SHAPE, WARP_DEPTHS = (3, 60, 80, 32), 128
RGB_SHAPE = (3, 240, 320, 3)
TP_RANKS = 2
# PixelNeRF's pixel latent (3 source views, 512 channels at half the
# 320x240 image) and the rays of a training step and of a render tile
PIX_LATENT_SHAPE, PIX_STEP_RAYS, PIX_TILE_RAYS = (3, 120, 160, 512), 512, 256
# kernel G against its plain version: equal values (it repeats the plain
# version's operations, one rounding each)
GRID_SAMPLE_SAME = dict(rtol=0.0, atol_frac=0.0)


def _warp_case(torch, dev):
    """Source features (WARP_SHAPE) and the projections of a plane sweep:
    a reference camera and, per batch entry, a source camera turned
    2-6 degrees about y and moved 0.1-0.3 along x, pinhole focal 70 px at
    the map's centre, WARP_DEPTHS depths from 0.5 to 3.0."""
    import math

    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    b, h, w, c = WARP_SHAPE
    feat = torch.randn(b, h, w, c, device=dev, generator=g)
    k = torch.tensor([[70.0, 0.0, w / 2], [0.0, 70.0, h / 2],
                      [0.0, 0.0, 1.0]], device=dev)
    proj = torch.zeros(b, 3, 4, device=dev)
    for i in range(b):
        a = math.radians(2.0 + 2.0 * i)
        rot = torch.tensor([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                            [-math.sin(a), 0.0, math.cos(a)]], device=dev)
        proj[i, :, :3] = k @ rot @ torch.linalg.inv(k)
        proj[i, :, 3] = k @ torch.tensor([0.1 + 0.1 * i, 0.0, 0.0],
                                         device=dev)
    depths = torch.linspace(0.5, 3.0, WARP_DEPTHS, device=dev).expand(b, -1)
    return feat, proj, depths.contiguous()


def _pixels_read(hw, uv, mode: str) -> int:
    """Distinct image pixels (view, y, x) the finite points read with a
    weight (zeros mode: corners inside the image)."""
    import torch
    h, w = hw
    ix = (uv[..., 0] + 1.0) * 0.5 * (w - 1)
    iy = (uv[..., 1] + 1.0) * 0.5 * (h - 1)
    if mode == "border":
        ix, iy = ix.clamp(0, w - 1), iy.clamp(0, h - 1)
    finite = torch.isfinite(uv).all(-1)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    view = torch.arange(uv.shape[0], device=uv.device)[:, None].expand(
        uv.shape[:2])
    ids = []
    for x in (x0, x0 + 1):
        for y in (y0, y0 + 1):
            ok = finite & (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
            ids.append((view * h + y.long()) * w + x.long())
            ids[-1] = ids[-1][ok]
    return int(torch.unique(torch.cat(ids)).numel())


def _tp_rank(points):
    """One rank of phase 14 (e), on the CPU: the NeRF MLP of MipNeRF-360
    (8 x 1024, float32) from SEED, its wide layers sharded over a
    TP_RANKS-wide "model" DeviceMesh by `tp_param_shardings` /
    `distribute_params`, one forward on `points`; returns the outputs and
    the local shape of the first layer's shard."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from neo360_tpu_torch.models.mipnerf360 import MipNeRF360MLP
    from neo360_tpu_torch.parallel import sharding

    mesh = init_device_mesh("cpu", (TP_RANKS,), mesh_dim_names=("model",))
    mlp = MipNeRF360MLP(8, 1024, generator=torch.Generator().manual_seed(
        SEED))
    sharding.distribute_params(mlp, mesh,
                               sharding.tp_param_shardings(mlp, mesh))
    with torch.no_grad():
        out = mlp(*points)
    return out, tuple(mlp.pts_0.weight.to_local().shape)


def _tp_points(torch):
    """4096 conical-frustum Gaussians (512 rays x 8 samples), viewdirs."""
    g = torch.Generator().manual_seed(SEED + 15)
    means = torch.randn(512, 8, 3, generator=g) * 0.5
    a = torch.randn(512, 8, 3, 3, generator=g) * 0.05
    covs = a @ a.transpose(-1, -2) + 1e-4 * torch.eye(3)
    dirs = torch.nn.functional.normalize(torch.randn(512, 3, generator=g),
                                         dim=-1)
    return means, covs, dirs


def phase_helpers(torch, card: str, dev: str = "cuda", **small):
    """The JAX package's helper functions on the card:

    (a) grid_sample_2d (kernel G, and G' in its image gradient) against
        its plain versions at the warp's shape (WARP_SHAPE features, the
        points of WARP_DEPTHS planes) and at RGB_SHAPE (uv in [-1.2, 1.2]
        and non-finite points), forward (equal values) and gradient, with
        time, bound, share, F.grid_sample's time and the table route's
        (`_grid_sample_tables`, the design G replaced); one call launches
        G once, its backward G' once, and neither launches A or A';
    (a2) PixelNeRF's latent (3,120,160,512), f32 and bf16, at its level
        points (3 x 512 x 65 and x 129): G and G' against their plain
        versions and the table route, then the two levels per training
        step (forward and latent gradient) and per 256-ray render tile
        (one table built for a view's 300 tiles) on G / G' against the
        table route;
    (b) homography_warp on the card against the CPU at the warp's shape,
        forward (one G) and the gradient with respect to the features
        (one G more, one G'), and the identity projection;
    (c) volume_rendering_volsdf, the core/rays.py helpers and
        charbonnier_loss on card tensors against the CPU;
    (d) profiling.trace around one full-width neo360_fast render tile:
        the Chrome trace holds its span and the tri-plane gather's
        kernel; a view's tiles in one item: its rays/s on the device
        timeline and each model phase's device ms (profiling.items);
    (e) tp_param_shardings: TP_RANKS gloo ranks (sharding.launch) run the
        sharded MipNeRF-360 NeRF MLP on the CPU (see TP_RANKS), which must
        give the unsharded forward to 1e-5 relative.

    Raises at its end if any check failed. Returns the G / G' rows and
    their launches on the path runs (each counted from 0, the calls held
    against the plain versions apart) for the {"kernels": ...} line. `dev`
    and `small` (preset overrides for (d)) are for a rehearsal
    elsewhere."""
    import glob

    import numpy as np

    from neo360_tpu_torch import cli
    from neo360_tpu_torch.config import preset
    from neo360_tpu_torch.core import geometry, rays, render
    from neo360_tpu_torch.data.fixtures import MemoryScenes
    from neo360_tpu_torch.ops import kernels, losses
    from neo360_tpu_torch.ops.interpolate import GRID_SAMPLE_TOL, \
        build_corner_table, grid_sample_2d, \
        grid_sample_2d_backward, grid_sample_2d_backward_reference, \
        grid_sample_2d_reference, table_sample
    from neo360_tpu_torch.parallel import sharding
    from neo360_tpu_torch.train import profiling

    dev = torch.device(dev)
    failures, results, seen = [], [], {}
    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False

    def check(ok: bool, what: str):
        print(f"[helpers] {'ok' if ok else 'FAILED'}: {what}")
        if not ok:
            failures.append(what)

    counted = ("grid_sample_fwd", "grid_sample_bwd", "table_sample_fwd",
               "table_sample_bwd")
    path = {k: 0 for k in HELPER_KERNELS}

    def launches(fn) -> dict:
        """Run `fn` with every count from 0, and add its G / G' launches
        to the path's (the {"kernels": ...} line's)."""
        _zero(counted)
        fn()
        torch.cuda.synchronize()
        counts = _read(counted)
        for k in path:
            path[k] += counts[k]
        return counts

    def only(fwd=0, bwd=0) -> dict:
        return {"grid_sample_fwd": fwd, "grid_sample_bwd": bwd,
                "table_sample_fwd": 0, "table_sample_bwd": 0}

    def timed(fn, port: bool = True) -> tuple:
        """(CUDA-event ms, device ms or None) of one call; `port`: `fn`
        launches a kernel of the port."""
        return _median_ms(fn, torch), _trusted_device_ms(torch, fn,
                                                          port=port)

    def vs_tables(row, tables_fn):
        """Time the table route (the design G / G' replaced) beside a
        G / G' row and print the row's comparison line."""
        row["tables_ms"], row["tables_device_ms"] = timed(tables_fn)
        print(f"[helpers] {row['name']} {row['case']}: {row['ms']:.4f} ms "
              f"(device {_fmt_ms(row['device_ms'], 1e3, 1)} us) | table "
              f"route "
              f"{row['tables_ms']:.4f} ms (device "
              f"{_fmt_ms(row['tables_device_ms'], 1e3, 1)} us) | "
              f"F.grid_sample "
              f"{row['library_ms']:.4f} ms | plain {row['plain_ms']:.4f} ms "
              f"| bound {row['bound_ms']:.4f} ms, share "
              f"{_share(row['bound_ms'], row['ms'])} (device "
              f"{_share(row['bound_ms'], row['device_ms'])}); {card}")

    # (a) grid_sample_2d, forward (G) and image gradient (G'), against the
    # plain versions, F.grid_sample and the table route
    feat, proj, depths = _warp_case(torch, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    rgb = torch.rand(RGB_SHAPE, device=dev, generator=g)
    rgb_uv = (torch.rand(RGB_SHAPE[0], RGB_SHAPE[1] * RGB_SHAPE[2], 2,
                         device=dev, generator=g) * 2 - 1) * 1.2
    rgb_uv[0, :5] = torch.tensor([[float("inf"), 0.0], [0.0, -float("inf")],
                                  [float("nan"), 0.3], [1e30, 0.0],
                                  [-1.0, 1.0]], device=dev)
    warp_case = "warp (3,60,80,32) f32, 128 depths"
    cases = ((warp_case, feat,
              geometry.homography_uv(WARP_SHAPE[1:3], proj, depths)),
             ("rgb (3,240,320,3) f32, non-finite points", rgb, rgb_uv))
    for case, image, u in cases:
        b, h, w, c = image.shape
        n = u.shape[1]
        pixels = _pixels_read((h, w), u, "zeros")
        cot = torch.randn(b, n, c, device=dev, generator=g)
        fwd = lambda: grid_sample_2d(image, u)
        plain = lambda: grid_sample_2d_reference(image, u)
        counts = seen[f"grid_sample_2d {case}"] = launches(fwd)
        check(counts == only(fwd=1),
              f"grid_sample_2d {case}: one call launches {counts}")
        # the bound: the pixels the points read, uv, the output
        _check("grid_sample_fwd", case, fwd(), plain(), fwd, plain, torch,
               results, GRID_SAMPLE_SAME,
               nbytes=4.0 * (pixels * c + u.numel() + b * n * c),
               ops=2.0 * b * n * 4 * c,
               library_fn=_grid_sample_fns(torch, c, torch.float32, u,
                                           (h, w), "zeros"),
               main=case == warp_case)
        vs_tables(results[-1], lambda: _grid_sample_tables(image, u, "zeros"))
        leaf = image.clone().requires_grad_()
        out = grid_sample_2d(leaf, u)
        bwd = lambda: torch.autograd.grad(out, leaf, cot,
                                          retain_graph=True)[0]
        plain_bwd = lambda: grid_sample_2d_backward_reference(
            cot, u, image.shape, image.dtype)
        counts = seen[f"its gradient, {case}"] = launches(bwd)
        check(counts == only(bwd=1),
              f"grid_sample_2d {case}: its image gradient launches "
              f"{counts}")
        # the cotangent and uv read once, the image's gradient written once
        _check("grid_sample_bwd", case, bwd(), plain_bwd(), bwd, plain_bwd,
               torch, results, GRID_SAMPLE_TOL,
               nbytes=4.0 * (cot.numel() + u.numel() + image.numel()),
               ops=2.0 * b * n * 4 * c,
               library_fn=_grid_sample_fns(torch, c, torch.float32, u,
                                           (h, w), "zeros", cot),
               main=case == warp_case)
        t_leaf = image.clone().requires_grad_()
        t_out = _grid_sample_tables(t_leaf, u, "zeros")
        vs_tables(results[-1], lambda: torch.autograd.grad(
            t_out, t_leaf, cot, retain_graph=True)[0])
        del out, t_out, leaf, t_leaf, cot

    # (a2) PixelNeRF's latent sample at its training shapes: G / G' against
    # the table route of models/pixelnerf.py (build_corner_table + A per
    # level, A' dense per level + the table's transpose), per training
    # step and per render tile with one table built for a view's 300 tiles
    view = _fixture_view(torch, dev)
    nv, ph, pw, pc = PIX_LATENT_SHAPE
    hw, levels = (ph, pw), (65, 129)
    step_uv = {s: _pixelnerf_uv(torch, view, PIX_STEP_RAYS, s)
               for s in levels}
    tile_uv = {s: _pixelnerf_uv(torch, view, PIX_TILE_RAYS, s)
               for s in levels}
    step_cot = {s: torch.randn(nv, PIX_STEP_RAYS * s, pc, device=dev,
                               generator=g) for s in levels}
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        latent = torch.randn(PIX_LATENT_SHAPE, device=dev, generator=g).to(dt)
        size = latent.element_size()
        u, cot = step_uv[129], step_cot[129]
        n = u.shape[0] * u.shape[1]
        case = (f"PixelNeRF latent {PIX_LATENT_SHAPE} {name}, {nv} x "
                f"{PIX_STEP_RAYS} x 129 pts")
        fwd = lambda: grid_sample_2d(latent, u)
        plain = lambda: grid_sample_2d_reference(latent, u)
        _check("grid_sample_fwd", case, fwd(), plain(), fwd, plain, torch,
               results, GRID_SAMPLE_SAME,
               nbytes=_pixels_read(hw, u, "zeros") * pc * size
               + 4.0 * (u.numel() + n * pc), ops=2.0 * n * 4 * pc,
               library_fn=_grid_sample_fns(torch, pc, dt, u, hw, "zeros"))
        table = build_corner_table(latent, "zeros", dtype=dt)
        vs_tables(results[-1], lambda: table_sample(
            build_corner_table(latent, "zeros", dtype=dt), u, hw, "zeros",
            dt))
        bwd = lambda: grid_sample_2d_backward(cot, u, latent.shape, dt)
        plain_bwd = lambda: grid_sample_2d_backward_reference(
            cot, u, latent.shape, dt)
        _check("grid_sample_bwd", case, bwd(), plain_bwd(), bwd, plain_bwd,
               torch, results, GRID_SAMPLE_TOL,
               nbytes=4.0 * (cot.numel() + u.numel()) + latent.numel() * size,
               ops=2.0 * n * 4 * pc,
               library_fn=_grid_sample_fns(torch, pc, dt, u, hw, "zeros",
                                           cot))
        t_leaf = latent.detach().requires_grad_()
        t_out = table_sample(build_corner_table(t_leaf, "zeros", dtype=dt),
                             u, hw, "zeros", dt)
        t_cot = cot.to(dt)
        vs_tables(results[-1], lambda: torch.autograd.grad(
            t_out, t_leaf, t_cot, retain_graph=True)[0])
        del t_out, t_leaf, t_cot
        cots = [step_cot[s].to(dt) for s in levels]

        def direct_step():
            leaf = latent.detach().requires_grad_()
            outs = [grid_sample_2d(leaf, step_uv[s]).to(dt) for s in levels]
            return torch.autograd.grad(outs, leaf, cots)[0]

        def table_step():
            leaf = latent.detach().requires_grad_()
            tab = build_corner_table(leaf, "zeros", dtype=dt)
            outs = [table_sample(tab, step_uv[s], hw, "zeros", dt)
                    for s in levels]
            return torch.autograd.grad(outs, leaf, cots)[0]

        def direct_tile():
            with torch.no_grad():
                return [grid_sample_2d(latent, tile_uv[s]).to(dt)
                        for s in levels]

        def table_tile():
            with torch.no_grad():
                return [table_sample(table, tile_uv[s], hw, "zeros", dt)
                        for s in levels]

        counts = seen[f"PixelNeRF step {name}"] = launches(direct_step)
        diff = kernels.compare(direct_step().float(), table_step().float(),
                               **(GRID_SAMPLE_TOL if dt == torch.float32
                                  else dict(rtol=2e-2, atol_frac=1e-2)))
        check(counts == only(fwd=2, bwd=2),
              f"PixelNeRF step {name}: the direct route launches {counts}")
        check(diff["ok"], f"PixelNeRF step {name}: the direct route's latent "
              f"gradient vs the table route's: max_abs {diff['max_abs']:.3e}")
        step = {"direct": timed(direct_step), "tables": timed(table_step)}
        tile = {"direct": timed(direct_tile), "tables": timed(table_tile)}
        build = timed(lambda: build_corner_table(latent, "zeros", dtype=dt),
                      port=False)
        print(f"[helpers] PixelNeRF {name} per training step (2 levels, "
              f"{nv} x {PIX_STEP_RAYS} x (65 + 129) pts, forward and latent "
              f"gradient): G + G' "
              f"{step['direct'][0]:.4f} ms (device "
              f"{_fmt_ms(step['direct'][1], 1e3, 1)} us) | table route "
              f"{step['tables'][0]:.4f} ms (device "
              f"{_fmt_ms(step['tables'][1], 1e3, 1)} us); {card}")
        print(f"[helpers] PixelNeRF {name} per render tile (2 levels, {nv} "
              f"x {PIX_TILE_RAYS} x (65 + 129) pts): G "
              f"{tile['direct'][0]:.4f} ms "
              f"(device {_fmt_ms(tile['direct'][1], 1e3, 1)} us) | table "
              f"route "
              f"{tile['tables'][0]:.4f} ms (device "
              f"{_fmt_ms(tile['tables'][1], 1e3, 1)} us) + the table's "
              f"build / 300 "
              f"{build[0] / 300:.4f} ms (device "
              f"{_fmt_ms(build[1], 1e3 / 300, 2)} "
              f"us; build {build[0]:.4f} ms); {card}")
        del latent, table

    # (b) homography_warp, card against the CPU, forward and the gradient
    # with respect to the source features
    warp = lambda: geometry.homography_warp(feat, proj, depths)
    counts = seen["homography_warp"] = launches(warp)
    on_card = warp()
    on_cpu = geometry.homography_warp(feat.cpu(), proj.cpu(), depths.cpu())
    res = kernels.compare(on_card.cpu(), on_cpu, **GRID_SAMPLE_TOL)
    ms = _median_ms(warp, torch)
    check(res["ok"] and counts == only(fwd=1)
          and tuple(on_card.shape) == (3, WARP_DEPTHS) + WARP_SHAPE[1:],
          f"homography_warp {tuple(on_card.shape)} card vs CPU: max_abs "
          f"{res['max_abs']:.3e} max_rel {res['max_rel']:.3e}; {ms:.4f} ms "
          f"a call; launches {counts}")
    warp_cot = torch.randn(on_card.shape, device=dev, generator=g)

    def warp_grad(src):
        leaf = src.clone().requires_grad_()
        out = geometry.homography_warp(leaf, proj.to(src.device),
                                       depths.to(src.device))
        return torch.autograd.grad(out, leaf, warp_cot.to(src.device))[0]

    counts = seen["homography_warp and its gradient"] = launches(
        lambda: warp_grad(feat))
    res = kernels.compare(warp_grad(feat).cpu(), warp_grad(feat.cpu()),
                          **GRID_SAMPLE_TOL)
    ms = _median_ms(lambda: warp_grad(feat), torch)
    check(res["ok"] and counts == only(fwd=1, bwd=1),
          f"homography_warp's gradient with respect to the features, card "
          f"vs CPU: max_abs {res['max_abs']:.3e} max_rel "
          f"{res['max_rel']:.3e}; forward + gradient {ms:.4f} ms; launches "
          f"{counts}")
    eye = geometry.homography_warp(feat, torch.eye(3, 4, device=dev).expand(
        3, 3, 4), torch.tensor([[1.0, 2.0]], device=dev).expand(3, 2))
    # uv -> pixel rounds x by up to (w - 1) * 2^-24, a weight that much off
    # 0 or 1 on a neighbour up to ~10 away: 1e-4
    err = max(float((eye[:, d] - feat).abs().max()) for d in range(2))
    check(err <= 1e-4, f"homography_warp identity: max |diff| {err:.3e} "
          f"(bound 1e-4)")
    del on_card, on_cpu, eye, warp_cot

    # (c) the small helpers, card against the CPU, on the same inputs
    hg = torch.Generator().manual_seed(SEED + 17)
    r = lambda *shape: torch.rand(*shape, generator=hg)
    t_vals = torch.sort(r(1024, 64) * 4 + 0.1, dim=-1).values
    o, d = (r(1024, 3) - 0.5) * 5, r(1024, 3) * 2 - 1
    q = torch.linalg.qr(torch.randn(3, 3, 3, generator=hg))[0]
    c2w = torch.eye(4)
    c2w[:3, :3] = q[0]
    box = ([-0.5, -0.4, -0.3], [0.6, 0.5, 0.4])
    helpers = {
        "volume_rendering_volsdf": (
            lambda *a: render.volume_rendering_volsdf(*a, True),
            (r(1024, 64, 3), r(1024, 64) * 5, t_vals, d)),
        "ndc_rays": (lambda *a: rays.ndc_rays(240, 320, 280.0, 1.0, *a),
                     (o, d)),
        "ray_aabb_intersection": (
            lambda *a: rays.ray_aabb_intersection(*a, *box), (o, d)),
        "sample_rays_in_bbox": (rays.sample_rays_in_bbox,
                                (o, d, q, r(3, 3) * 0.3, r(3, 3) * 0.4 + 0.2)),
        "get_rays_mvs": (lambda a: rays.get_rays_mvs(240, 320, 280.0, a),
                         (c2w,)),
        "charbonnier_loss": (lambda *a: (losses.charbonnier_loss(*a),),
                             (r(4096, 3), r(4096, 3))),
    }
    for name, (fn, args) in helpers.items():
        ours = fn(*(a.to(dev) for a in args))
        ref = fn(*args)
        errs = [kernels.compare(a.cpu().float(), b.float())
                if a.dtype != torch.bool else
                {"ok": torch.equal(a.cpu(), b), "max_abs": 0.0}
                for a, b in zip(ours, ref)]
        check(all(e["ok"] for e in errs),
              f"{name}: card vs CPU max_abs "
              f"{max(e['max_abs'] for e in errs):.3e} (1e-5 relative)")

    # (d) profiling.trace around one full-width neo360_fast render tile
    cfg = preset("neo360_fast", seed=SEED, **small)
    model = cli.build_model(cfg, dev)
    sample = MemoryScenes(1, cfg.img_wh, cfg.num_src_views).sample_test(0, 0)
    src = {k: torch.as_tensor(sample[k], device=dev) for k in cli.SRC_KEYS}
    ray_in = {k: torch.as_tensor(sample[k], device=dev)
              for k in cli.RAY_KEYS}
    n_rays = ray_in["rays_o"].shape[0]
    with torch.inference_mode():
        enc = model.encode(*(src[k] for k in cli.SRC_KEYS), True)

        def tile(i):
            with profiling.span("neo360_fast_render_tile"):
                chunk = {k: v[i:i + cfg.chunk] for k, v in ray_in.items()}
                return model(dict(chunk, **src), enc, cfg.white_back,
                             out_depth=True)[1]["rgb"]

        tile(0)
        with tempfile.TemporaryDirectory() as log_dir:
            _zero(("triplane_sample_fwd",))
            with profiling.trace(log_dir):
                tile(0)
            traces = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
            with open(traces[0]) as f:
                events = json.load(f)["traceEvents"]
            size = os.path.getsize(traces[0])
        spans = [e for e in events
                 if e.get("name") == "neo360_fast_render_tile"]
        gathers = [e for e in events if e.get("cat") == "kernel"
                   and "triplane_sample" in e.get("name", "")]
        seen["render tile"] = _read(("triplane_sample_fwd",))
        check(len(traces) == 1 and spans and gathers
              and seen["render tile"]["triplane_sample_fwd"] == 1,
              f"profiling.trace: {len(traces)} trace file ({size} bytes, "
              f"{len(events)} events): {len(spans)} span, "
              f"{len(gathers)} triplane_sample kernel event "
              f"({gathers[0]['name'][:60] if gathers else '-'}, "
              f"{gathers[0].get('dur') if gathers else '-'} us), launches "
              f"{seen['render tile']['triplane_sample_fwd']}")
        with profiling.item("neo360_fast_render_view"):
            for i in range(0, n_rays, cfg.chunk):
                tile(i)
        view = profiling.items()[-1]["spans"]
    tiles = view["neo360_fast_render_tile"]
    ms = view["neo360_fast_render_view"]
    n_tiles = -(-n_rays // cfg.chunk)
    timed = "device_ms" if dev.type == "cuda" else "host_ms"
    check(ms["count"] == 1 and tiles["count"] == n_tiles
          and all(r[timed] is not None and r[timed] >= 0
                  for r in view.values()),
          f"profiling.span: a view's {tiles['count']} tile spans of "
          f"{n_tiles}, {timed} of every span read")
    print(f"[helpers] spans: {n_rays / ms[timed] * 1e3:.0f} rays/s by "
          f"{timed} ({ms[timed]:.1f} ms; host {ms['host_ms']:.1f} ms) over "
          f"a view's {n_tiles} tiles of {cfg.chunk} rays (neo360_fast, full "
          f"width, random weights); " + ", ".join(
              f"{k} {v[timed]:.1f} ms" for k, v in view.items()
              if k.startswith("model.")) + f"; {card}")
    del model, enc, src, ray_in

    # (e) tensor parallelism: TP_RANKS gloo ranks on the CPU
    from neo360_tpu_torch.models.mipnerf360 import MipNeRF360MLP
    print(f"[helpers] (e) runs its {TP_RANKS} gloo ranks on the CPU: "
          f"DTensor's all-gather of CUDA tensors through gloo segfaults")
    points = _tp_points(torch)
    t = time.perf_counter()
    ranks = sharding.launch(_tp_rank, TP_RANKS, points, backend="gloo",
                            device="cpu")
    seconds = time.perf_counter() - t
    mlp = MipNeRF360MLP(8, 1024, generator=torch.Generator().manual_seed(
        SEED))
    with torch.no_grad():
        ref = mlp(*points)
    for rank, (out, shard) in enumerate(ranks):
        errs = {k: kernels.compare(out[k], ref[k], rtol=1e-5)
                for k in ref}
        check(all(e["ok"] for e in errs.values()) and shard == (512, 504),
              f"tp rank {rank}: sharded NeRF MLP (8 x 1024, f32; pts_0 "
              f"shard {shard}) vs the unsharded forward, CPU: "
              + ", ".join(f"{k} max_rel {e['max_rel']:.3e}"
                          for k, e in errs.items())
              + f" ({seconds:.1f} s with start-up)")

    torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"[helpers] launches of one call (apart from the kernels line): "
          f"{json.dumps(seen)}")
    print(f"[helpers] G / G' launches of the path runs (each counted from "
          f"0, the calls compared with the plain versions apart): "
          f"{json.dumps(path)}")
    print(f"[helpers] phase: {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError(f"helpers phase: {failures}")
    return results, path


# NeRFTP's narrow widths on the card: plane_dim and local_proj_dim of the
# gathers and of A' accumulate, the latent width of C; the narrow stage's
# knobs (a pillar width of 16 for the encoder width of 64)
NARROW_WIDTHS = (32, 64, 96)
NARROW_STAGE = dict(plane_dim=64, local_proj_dim=64, pillar_width=16,
                    depth_fc_layers=1)
# the bench's short runs: (label, flags, the launches of one window)
BENCH_RUNS = (
    ("proposal train", ["--repeats", "3"],
     dict(table_sample_fwd=2, triplane_sample_fwd=64, local_sample_fwd=64,
          composite_nerfpp_fwd=128, pillar_collapse_fwd=2,
          table_sample_bwd=2, table_sample_bwd_acc=256,
          composite_nerfpp_bwd=128, pillar_collapse_bwd=2)),
    ("proposal render", ["--phase", "render", "--repeats", "2"],
     dict(triplane_sample_fwd=300, local_sample_fwd=300,
          composite_nerfpp_fwd=600)),
    ("reference train", ["--mode", "reference", "--steps", "1",
                         "--repeats", "3"],
     {k: n for k, n in _neo360_step_launches(True).items() if n}),
)


def _check_narrow(torch, view):
    """The kernels the width knobs reshape, against their plain versions,
    at C = NARROW_WIDTHS channels in bf16 and f32: the fused tri-plane and
    local gathers at scene 1 of a neo360_fast stage step (250 rays x 61
    fine points, flat two-scene tables), kernel A' under the accumulate
    contract at that step's ray-structured points (cotangent in the
    table's type, f32 accumulators), and kernel C on a (3, 64, 64, 32, C)
    latent."""
    from neo360_tpu_torch.nn.resnet import latent_scaling
    from neo360_tpu_torch.ops.interpolate import BACKWARD_TOL as A_TOL
    from neo360_tpu_torch.ops.interpolate import FUSED_TOL, local_sample, \
        local_sample_reference, local_uv, table_sample_accumulate, \
        table_sample_accumulate_reference, triplane_sample, \
        triplane_sample_reference, triplane_uvs
    from neo360_tpu_torch.ops.pillar import pillar_collapse, \
        pillar_collapse_reference

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    hw = (120, 160)
    focal, c = view["src_focal"], view["src_c"]
    scale = (latent_scaling(hw) / torch.tensor([320.0, 240.0])).tolist()
    cam = _level_cam(torch, view, 250, 61)
    nv, n = cam.shape[:2]
    results = []
    for ch in NARROW_WIDTHS:
        for dt in (torch.bfloat16, torch.float32):
            name = {torch.bfloat16: "bf16", torch.float32: "f32"}[dt]
            case = f"C={ch} {name}, stage scene 1, 250 rays x 61"
            size = torch.finfo(dt).bits // 8
            planes = [torch.randn(6, 121, 161, 4 * ch, device=dev,
                                  generator=g).to(dt) for _ in range(3)]
            kernel = lambda: triplane_sample(planes, cam, hw, 3)
            plain = lambda: triplane_sample_reference(planes, cam, hw, 3)
            uvs = triplane_uvs(cam)
            rows = sum(_rows_read(t.shape, u, hw, "zeros", 3)
                       for t, u in zip(planes, uvs))
            _check("triplane_sample_fwd", case, kernel(), plain(), kernel,
                   plain, torch, results, FUSED_TOL,
                   nbytes=cam.numel() * 4 + rows * 4 * ch * size
                   + nv * n * ch * 4,
                   ops=3 * 2.0 * nv * n * 4 * ch + 2.0 * nv * n * ch,
                   library_fn=_grid_sample_fns(torch, ch, dt,
                                               torch.cat(uvs, 0), hw,
                                               "zeros"))
            table = torch.randn(12, 121, 161, 4 * ch, device=dev,
                                generator=g).to(dt)
            kernel = lambda: local_sample(table, cam, focal, c, scale, hw, 6)
            plain = lambda: local_sample_reference(table, cam, focal, c,
                                                   scale, hw, 6)
            u = local_uv(cam, focal, c, scale)
            rows = _rows_read(table.shape, u, hw, "border", 6)
            _check("local_sample_fwd", case, kernel(), plain(), kernel,
                   plain, torch, results, FUSED_TOL,
                   nbytes=cam.numel() * 4 + rows * 4 * ch * size
                   + nv * n * ch * 4,
                   ops=2.0 * nv * n * 4 * ch + 8.0 * nv * n,
                   library_fn=_grid_sample_fns(torch, ch, dt, u, hw,
                                               "border"))
            del planes, table
            for label, shape, mode, off, (b, n_rays, s) in (
                    ("plane zeros", (6, 121, 161, 4 * ch), "zeros", 3,
                     (3, 500, 61)),
                    ("local border", (12, 121, 161, 4 * ch), "border", 6,
                     (6, 250, 61))):
                u = _ray_uv(torch, g, b, n_rays, s)
                cot = torch.randn(b, n_rays * s, ch, device=dev,
                                  generator=g).to(dt)
                acc = torch.zeros(shape, device=dev)
                ref = torch.zeros(shape, device=dev)
                table_sample_accumulate(cot, u, acc, hw, mode, off)
                table_sample_accumulate_reference(cot, u, ref, hw, mode, off)
                acc_t, ref_t = acc.clone(), ref.clone()   # timed adds
                kernel = lambda: table_sample_accumulate(cot, u, acc_t, hw,
                                                         mode, off)
                plain = lambda: table_sample_accumulate_reference(
                    cot, u, ref_t, hw, mode, off)
                rows = _rows_read(shape, u, hw, mode, off)
                _check("table_sample_bwd", f"accumulate {label} C={ch} "
                       f"{name} cotangent, view_offset={off}", acc, ref,
                       kernel,
                       plain, torch, results, A_TOL,
                       nbytes=cot.numel() * size + u.numel() * 4
                       + rows * shape[-1] * 4 * 2,
                       ops=2.0 * cot.numel() * 4,
                       library_fn=_grid_sample_fns(torch, ch, dt, u, hw, mode,
                                                   cot))
                del acc, ref, acc_t, ref_t, cot
            shape = (3, 64, 64, 32, ch)
            latent = torch.randn(shape, device=dev, generator=g).to(dt)
            logits = [(torch.randn(shape[:4], device=dev, generator=g)
                       * 3).to(dt) for _ in range(3)]
            kernel = lambda: pillar_collapse(latent, *logits)
            plain = lambda: pillar_collapse_reference(latent, *logits)
            cells = latent.numel() // ch
            floor_elems = 3 * (64 * 32 + 64 * 32 + 64 * 64) * ch
            _check("pillar_collapse_fwd", f"latent {shape} {name}",
                   kernel(), plain(), kernel, plain, torch, results,
                   nbytes=size * (latent.numel() + 3 * cells + floor_elems),
                   ops=3.0 * (latent.numel() * 2 + cells * 4))
            del latent, logits
    return results


def phase_bench(torch):
    """The port's benchmark (`neo360_tpu_torch.bench`, as `python -m
    neo360_tpu_torch.bench` runs it) in this process, with short windows:
    neo360_fast proposal training (1 warm-up and 3 timed stages of K=32,
    S=2, 500 rays a step), its render (1 warm-up and 2 timed 320x240
    views) and neo360 reference training (1 warm-up and 3 timed steps of
    the per-step trainer); each result is printed on a "[bench]" line and
    the launches of its last window must be BENCH_RUNS'. Before them, the
    narrow widths' kernels against their plain versions (`_check_narrow`)
    and one narrow-knob tiny stage, card against CPU (NARROW_STAGE).
    Returns (the kernel checks, the bench runs' launches, each counted
    from 0 and summed)."""
    from neo360_tpu_torch import bench

    t_phase = time.perf_counter()
    checks = _check_narrow(torch, _fixture_view(torch))
    phase_small_train(torch, **NARROW_STAGE)
    fns = counters()
    total = {k: 0 for k in fns}
    failures = []
    for label, argv, want in BENCH_RUNS:
        _zero(fns)
        out = bench.run(bench.parse_args(["--seed", str(SEED)] + argv))
        for k, n in _read(fns).items():
            total[k] += n
        print(f"[bench] {json.dumps(out)}")
        print(f"[bench] {label}: {out['value']:.1f} rays/s, median "
              f"{out['median_s']:.4f} s ({out['min_s']:.4f}-"
              f"{out['max_s']:.4f}, n={out['n']}), first {out['first_s']:.3f}"
              f" s, peak {out['peak_gib']:.2f} GiB; launches of a window "
              f"{out['launches']}, expected {want}")
        finite = all(math.isfinite(out[k]) and out[k] > 0 for k in
                     ("value", "median_s", "min_s", "max_s", "first_s"))
        if out["launches"] != want or not finite:
            failures.append(label)
        torch.cuda.empty_cache()
    print(f"[bench] phase: {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError(f"bench runs with unexpected launches or "
                             f"figures: {failures}")
    return checks, total


def _kernel_entry(name, source, replaces, launches, rows, main) -> dict:
    """A kernel's entry of the {"kernels": ...} line: its launches on the
    main paths, its largest error over `rows` (its checks) and the numbers
    of its `main` case."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs"] for r in rows),
            "ms": main["ms"], "device_ms": main["device_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"]}


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

    from neo360_tpu_torch.train.profiling import graphs
    card = phase_card(torch)
    phase_build()
    done("build")
    checks = phase_kernels(torch) + phase_backward_kernels(torch)
    done("kernels")
    tiles = dict(graphs)
    phase_small_reference(torch)
    phase_small_train(torch)
    phase_small_neo360_step(torch)
    phase_sync(torch)
    tiles = _graph_line("small card-vs-CPU checks", tiles)
    done("small card-vs-CPU checks")
    work = tempfile.TemporaryDirectory()
    trained = os.path.join(work.name, "neo360_fast_96.pt")
    launches, per_stage, _, _ = phase_train_main_path(torch, trained)
    tiles = _graph_line("neo360_fast training", tiles)
    done("neo360_fast training")
    from neo360_tpu_torch.config import preset
    serve_launches, per_view = phase_main_path(
        torch, preset("neo360_fast", seed=SEED))
    tiles = _graph_line("neo360_fast serving", tiles)
    done("neo360_fast serving")
    neo_launches, neo_per_step, neo_per_view = phase_neo360_main_path(torch)
    tiles = _graph_line("neo360 training and serving", tiles)
    done("neo360 training and serving")
    opt_launches, opt_per_step = phase_optimize_finetune(torch, trained)
    work.cleanup()
    tiles = _graph_line("neo360_fast optimize and finetune", tiles)
    done("neo360_fast optimize and finetune")
    van_launches, van_per_step, van_per_view, _ = phase_vanilla_main_path(
        torch)
    tiles = _graph_line("vanilla training and evaluation", tiles)
    done("vanilla training and evaluation")
    pix_launches, pix_per_step, pix_per_view, _ = \
        phase_pixelnerf_main_path(torch)
    tiles = _graph_line("pixelnerf training and serving", tiles)
    done("pixelnerf training and serving")
    mip_launches, mip_per_step, mip_per_view, _ = \
        phase_mipnerf360_main_path(torch)
    tiles = _graph_line("mipnerf360 training and evaluation", tiles)
    done("mipnerf360 training and evaluation")
    phase_data_parallel(torch)      # the ranks count their own tiles
    done("data-parallel ranks")
    tiles = dict(graphs)
    helper_checks, helper_launches = phase_helpers(torch, card)
    tiles = _graph_line("helpers", tiles)
    done("helpers")
    bench_checks, bench_launches = phase_bench(torch)
    _graph_line("bench", tiles)
    checks += bench_checks
    done("bench")

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
    for launches_ in (opt_launches, van_launches, pix_launches,
                      mip_launches, bench_launches):
        for k, n in _by_kernel(launches_).items():
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
              f"{opt_step[name]} per optimize step; vanilla "
              f"{van_per_step[1][name]} per training step, "
              f"{van_per_view[0][name]} per view; pixelnerf "
              f"{pix_per_step[1][name]} per training step, "
              f"{pix_per_view[0][name]} per view; mipnerf360 "
              f"{mip_per_step[1][name]} per training step, "
              f"{mip_per_view[0][name]} per view; "
              f"{main['case']}: {main['ms']:.4f} ms (device "
              f"{_fmt_ms(main['device_ms'])} ms), bound "
              f"{main['bound_ms']:.4f} ms "
              f"({main['bound_by']}), share "
              f"{_share(main['bound_ms'], main['ms'])} (device "
              f"{_share(main['bound_ms'], main['device_ms'])})")
        entries.append(_kernel_entry(name, source, replaces, total[name],
                                     rows, main))
    for name, (source, replaces) in HELPER_KERNELS.items():
        rows = [r for r in helper_checks if r["name"] == name]
        main = next(r for r in rows if r["main"])
        print(f"[kernel] {name}: {helper_launches[name]} launches on phase "
              f"14's path; {main['case']}: {main['ms']:.4f} ms (device "
              f"{_fmt_ms(main['device_ms'])} ms), bound "
              f"{main['bound_ms']:.4f} ms "
              f"({main['bound_by']}), share "
              f"{_share(main['bound_ms'], main['ms'])} (device "
              f"{_share(main['bound_ms'], main['device_ms'])}); the table "
              f"route {main['tables_ms']:.4f} ms, F.grid_sample "
              f"{main['library_ms']:.4f} ms")
        entries.append(_kernel_entry(name, source, replaces,
                                     helper_launches[name], rows, main))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
