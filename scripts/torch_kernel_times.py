#!/usr/bin/env python3
"""Device time per call of the PyTorch port's CUDA kernels at the
neo360_fast and neo360 training and render shapes, on one NVIDIA GPU.

    python3 scripts/torch_kernel_times.py [--tree DIR]

Each case runs its wrapper 20 times under torch.profiler and prints the
device time per call of every kernel it launched (memsets included) and
their sum, beside the wrapper's CUDA-event time (median of 20 single
calls); both helpers are chip_smoke.py's. For a kernel of a few
microseconds the event time measures the wrapper's host work, while the
device time does not. A last case times a device copy of the grid latent
(`clone`), the memory rate that kernel C′'s one pass over it can reach.

`--tree DIR` imports neo360_tpu_torch from DIR instead of this checkout
(a checkout of another commit, unpacked with `git archive`), so that two
versions can be compared in one run on one card. The cases call only
wrappers that every version of the port has, apart from the accumulate
contract of kernel A', which is skipped where it is missing; a case whose
shape the imported version refuses (kernel C at Z > 32 before it took
them) prints the refusal.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import _device_ms, _median_ms  # noqa: E402


def short(name: str) -> str:
    """A kernel's name without its namespaces, template and arguments."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return re.split(r"[<(]", name, 1)[0].split("::")[-1].strip()


def cases(torch):
    """(kernel, case, fn) at the path's shapes, seeded."""
    from neo360_tpu_torch.core import render
    from neo360_tpu_torch.ops import interpolate, pillar

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    hw = (120, 160)

    def rand(*shape):
        return torch.rand(*shape, device=dev, generator=g)

    def uniform_uv(b, n, lim=1.2):
        return (rand(b, n, 2) * 2 - 1) * lim

    def ray_uv(b, n_rays, s, lim=1.2, reach=0.5):
        start = (rand(b, n_rays, 1, 2) * 2 - 1) * lim
        step = torch.randn(b, n_rays, 1, 2, device=dev, generator=g) * reach
        t = torch.sort(rand(b, n_rays, s, 1), 2).values
        return (start + t * step).reshape(b, n_rays * s, 2)

    out = []
    table = rand(6, 121, 161, 512).to(bf16)
    plane_uv = uniform_uv(3, 2 * 250 * 61)
    out.append(("A table_sample_fwd", "plane bf16->f32, view_offset=3",
                lambda: interpolate.table_sample(table, plane_uv, hw,
                                                 "zeros", f32, 3)))
    lift_uv = uniform_uv(3, 64 * 64 * 32, 1.5)
    for case, shape, uv, mode, gdt, off in (
            ("dense lift, bf16 cotangent", (3, 121, 161, 512), lift_uv,
             "zeros", bf16, 0),
            ("dense plane, view_offset=3", (6, 121, 161, 512), plane_uv,
             "zeros", f32, 3),
            ("dense local, view_offset=6", (12, 121, 161, 512),
             uniform_uv(6, 250 * 61), "border", f32, 6)):
        cot = torch.randn(uv.shape[:2] + (128,), device=dev,
                          generator=g).to(gdt)
        out.append(("A' table_sample_bwd", case,
                     lambda cot=cot, uv=uv, shape=shape, mode=mode, off=off:
                     interpolate.table_sample_backward(cot, uv, shape, bf16,
                                                       hw, mode, off)))
    if hasattr(interpolate, "table_sample_accumulate"):
        for case, shape, uv, mode in (
                ("accumulate plane, ray uv", (6, 121, 161, 512),
                 ray_uv(3, 500, 61), "zeros"),
                ("accumulate plane, uniform uv", (6, 121, 161, 512),
                 plane_uv, "zeros"),
                ("accumulate local, ray uv", (12, 121, 161, 512),
                 ray_uv(6, 250, 61), "border")):
            cot = torch.randn(uv.shape[:2] + (128,), device=dev, generator=g)
            acc = torch.zeros(shape, device=dev)
            out.append(("A' table_sample_bwd", case,
                        lambda cot=cot, uv=uv, acc=acc, mode=mode:
                        interpolate.table_sample_accumulate(cot, uv, acc, hw,
                                                            mode)))
    def composite_args(b, s):
        fg_t = torch.sort(rand(b, s), -1).values
        bg_t = torch.sort(rand(b, s), -1, descending=True).values
        return (rand(b, s, 3), rand(b, s, 1) * 10, fg_t, rand(b, s, 3),
                rand(b, s, 1) * 10, bg_t,
                torch.randn(b, 3, device=dev, generator=g),
                fg_t[:, -1:] + rand(b, 1))

    # B at the render and train tiles (256 rays); B' at the train path's
    # 250 rays per scene, with the loss's cotangents (rgb, both weights)
    for s in (65, 61):
        args = composite_args(256, s)
        out.append(("B composite_nerfpp_fwd", f"256 rays x {s}",
                    lambda args=args: render.composite_nerfpp(*args)))
    for s in (65, 61):
        args = composite_args(250, s)
        grads = [torch.randn(250, 3, device=dev, generator=g) if k == "rgb"
                 else torch.randn(250, s, device=dev, generator=g)
                 if k in ("fg_weights", "bg_weights") else None
                 for k in render.OUT_KEYS]
        out.append(("B' composite_nerfpp_bwd", f"250 rays x {s}",
                    lambda args=args, grads=grads:
                    render.composite_nerfpp_backward(args, grads)))
    latent = torch.randn(3, 64, 64, 32, 512, device=dev,
                         generator=g).to(bf16)
    logits = [(torch.randn(3, 64, 64, 32, device=dev, generator=g) * 3).to(
        bf16) for _ in range(3)]
    out.append(("C pillar_collapse_fwd", "latent (3,64,64,32,512) bf16",
                lambda: pillar.pillar_collapse(latent, *logits)))
    cots = [torch.randn(s, device=dev, generator=g).to(bf16) for s in
            ((3, 64, 32, 512), (3, 64, 32, 512), (3, 64, 64, 512))]
    out.append(("C' pillar_collapse_bwd", "latent (3,64,64,32,512) bf16",
                lambda: pillar.pillar_collapse_backward([latent, *logits],
                                                        cots)))
    # a yardstick, not a kernel of the port: the latent read once and
    # written once, as C' reads it and writes d latent
    out.append(("(copy)", "latent.clone(), 403 MB read + 403 MB written",
                latent.clone))

    # the neo360 preset: the f32 lift of the 512-channel pixel latent at
    # the 64^3 grid (A, and A' dense once per step), the f32 grid latent
    # (3,64,64,64,512) through C and C' (and C in bf16)
    lift = rand(3, 121, 161, 2048)
    lift_uv = uniform_uv(3, 64 ** 3, 1.5)
    out.append(("A table_sample_fwd", "neo360 lift f32->f32, 3 x 64^3 pts",
                lambda: interpolate.table_sample(lift, lift_uv, hw, "zeros",
                                                 f32)))
    lift_cot = torch.randn(3, 64 ** 3, 512, device=dev, generator=g)
    out.append(("A' table_sample_bwd", "dense neo360 lift, f32 cotangent",
                lambda: interpolate.table_sample_backward(
                    lift_cot, lift_uv, lift.shape, f32, hw, "zeros")))
    for dt, name in ((f32, "f32"), (bf16, "bf16")):
        lat = torch.randn(3, 64, 64, 64, 512, device=dev, generator=g).to(dt)
        lgs = [(torch.randn(3, 64, 64, 64, device=dev, generator=g) * 3).to(
            dt) for _ in range(3)]
        out.append(("C pillar_collapse_fwd", f"latent (3,64,64,64,512) {name}",
                    lambda lat=lat, lgs=lgs: pillar.pillar_collapse(lat,
                                                                    *lgs)))
        if dt == f32:
            cts = [torch.randn(s, device=dev, generator=g) for s in
                   ((3, 64, 64, 512), (3, 64, 64, 512), (3, 64, 64, 512))]
            out.append(("C' pillar_collapse_bwd",
                        "latent (3,64,64,64,512) f32",
                        lambda lat=lat, lgs=lgs, cts=cts:
                        pillar.pillar_collapse_backward([lat, *lgs], cts)))
            out.append(("(copy)", "latent.clone(), 1.61 GB read + written",
                        lat.clone))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=ROOT)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import neo360_tpu_torch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(f"[times] {card.strip()}; package "
          f"{os.path.dirname(neo360_tpu_torch.__file__)}")
    for kernel, case, fn in cases(torch):
        try:
            per = {k: v * 1e3 for k, v in _device_ms(torch, fn).items()}
        except ValueError as e:
            print(f"[times] {kernel} {case}: refused: {e}")
            continue
        parts = ", ".join(f"{short(k)} {v:.1f}" for k, v in sorted(
            per.items(), key=lambda kv: -kv[1]))
        print(f"[times] {kernel} {case}: device {sum(per.values()):.1f} "
              f"us/call ({parts}); event {_median_ms(fn, torch):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
