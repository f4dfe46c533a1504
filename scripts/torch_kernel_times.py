#!/usr/bin/env python3
"""Device time per call of the PyTorch port's CUDA kernels at the
neo360_fast and neo360 training and render shapes, on one NVIDIA GPU.

    python3 scripts/torch_kernel_times.py [--tree DIR] [--only PREFIXES]
    python3 scripts/torch_kernel_times.py --sweep [--only PREFIXES]

Each case runs its wrapper 20 times under torch.profiler and prints the
device time per call of every kernel it launched (memsets included) and
their sum, from the first of up to 5 profiles that recorded every kernel
at least once a call (else marked "not trusted"), beside the wrapper's
CUDA-event time (median of 20 single calls); both helpers are
chip_smoke.py's. For a kernel of a few
microseconds the event time measures the wrapper's host work, while the
device time does not. Yardsticks that are no kernel of the port: a device
copy of the grid latent (`clone`), the memory rate that kernel C′'s one
pass over it can reach, a memset of the neo360 lift's output, and at
kernel A's unfused calls at the neo360 level shapes (no call site since
the fused gathers) its plain version and `F.grid_sample`, with A's bound
in the case's name.

Kernel A at the neo360 lift is timed at uniform uv, at the grid's own uv
(a fixture scene's source views) and with every point in one cell; the
"level gathers" cases time one conditioned level's tri-plane and local
gathers from its world points (a fixture view's rays): the fused kernels
where the imported version has them, else its unfused chain.

Kernels G / G' (`grid_sample_2d`, forward and image gradient through
autograd) are timed at the plane-sweep warp, an RGB image and PixelNeRF's
latent; a checkout before them runs the same calls through the image's
corner table, A and A' (the route they replaced).

Kernels D / D' (the plain NeRF composite and its gradient) are timed at
chip_smoke's VANILLA_SHAPES, D' at the four training shapes with the
loss's rgb cotangent; kernels E / E' (the MipNeRF-360 composite and its
gradient) at chip_smoke's MIP_SHAPES (opaque background, background
1.0), E' at its three cotangent sets (2048 x 32 weights and rgb, 2048 x
64 weights, 4096 x 64 all four) with the acc of E; each with its bound
in the case's name. Before the cases, the script prints the card's
launch floor: the device time of `zero_()` on a 1-element tensor, a
yardstick that is no kernel of the port. `--only D` or `--only E` times
those kernels and the floor without building the other cases.

`--tree DIR` imports neo360_tpu_torch from DIR instead of this checkout
(a checkout of another commit, unpacked with `git archive`), so that two
versions can be compared in one run on one card. The cases call only
wrappers that every version of the port has, apart from the accumulate
contract of kernel A', which is skipped where it is missing; a case whose
shape the imported version refuses (kernel C at Z > 32 before it took
them) prints the refusal. `--only` keeps the cases whose kernel name
starts with one of the comma-separated prefixes. `--sweep` times kernel
A's, the level gathers' and kernel G''s cases at every run length of
`SWEEP_RUNS` (the points a group of threads walks: the wrappers' `run`
argument, else ops.interpolate's TABLE_SAMPLE_RUN, TRIPLANE_SAMPLE_RUN,
LOCAL_SAMPLE_RUN and GRID_SAMPLE_BWD_RUN).
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import MIP_SHAPES, PROFILE_TRIES, TIMED_RUNS, \
    VANILLA_SHAPES, _bound, _device_ms, _fixture_view, _grid_sample_fns, \
    _level_cam, _level_points, _lift_uv, _median_ms, _mip_args, \
    _pixelnerf_uv, _rows_read, _vanilla_args, _warp_case  # noqa: E402

# run lengths that --sweep tries (the wrappers' `run` argument)
SWEEP_RUNS = (1, 2, 4, 8, 16, 32)
# printed beside a time whose profiles all lost events
LOST = (f" [not trusted: every one of {PROFILE_TRIES} profiles lost "
        f"events]")


def device_us(torch, fn):
    """({kernel: device us per call} of `fn`, whether the profile recorded
    every kernel at least once a call): the first of PROFILE_TRIES
    profiles that did, else the last. The profiler can drop the events of
    a few-us kernel, and a profile that lost some reads too low."""
    for _ in range(PROFILE_TRIES):
        calls = {}
        per = {k: v * 1e3 for k, v in _device_ms(torch, fn, calls).items()}
        if min(calls.values(), default=0) >= TIMED_RUNS:
            return per, True
    return per, False


def short(name: str) -> str:
    """A kernel's name without its namespaces, template and arguments."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return re.split(r"[<(]", name, 1)[0].split("::")[-1].strip()


def vanilla_cases(torch):
    """(kernel, case, fn) of kernels D and D' at the baselines' shapes,
    seeded: D at VANILLA_SHAPES, D' at its first four (the training
    levels) with the loss's cotangent (rgb alone). These are the only
    cases whose kernel name starts with "D"."""
    from neo360_tpu_torch.core import render

    g = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for b, s in VANILLA_SHAPES:
        args = _vanilla_args(torch, g, b, s)
        # chip_smoke's bound: rgb, sigma, t read and a weight written a
        # sample; dirs read, comp, acc, depth written a ray
        bound_ms, _ = _bound(4.0 * b * (6 * s + 8), 20.0 * b * s)
        out.append(("D composite_vanilla_fwd",
                    f"{b} rays x {s} (bound {bound_ms * 1e3:.2f} us)",
                    lambda args=args: render.composite_vanilla(*args,
                                                               False)))
    for b, s in VANILLA_SHAPES[:4]:
        args = _vanilla_args(torch, g, b, s)
        grads = [torch.randn(b, 3, device="cuda", generator=g), None, None,
                 None]
        # rgb, sigma, t read, d rgb and d sigma written a sample; dirs
        # and the rgb cotangent read a ray
        bound_ms, _ = _bound(4.0 * b * (9 * s + 6), 40.0 * b * s)
        out.append(("D' composite_vanilla_bwd",
                    f"{b} rays x {s}, rgb cotangent (bound "
                    f"{bound_ms * 1e3:.2f} us)",
                    lambda args=args, grads=grads:
                    render.composite_vanilla_backward(args, grads, False)))
    return out


def mip_cases(torch):
    """(kernel, case, fn) of kernels E and E' at the MipNeRF-360 shapes,
    seeded: E at MIP_SHAPES, E' at chip_smoke's three cotangent sets,
    with the acc of E. These are the only cases whose kernel name starts
    with "E"."""
    from neo360_tpu_torch.core import render

    g = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for b, s in MIP_SHAPES:
        args = _mip_args(torch, g, b, s)
        # chip_smoke's bound: density, rgb, tdist read and a weight
        # written an interval; dirs and the last edge read, rgb, acc,
        # depth written a ray
        bound_ms, _ = _bound(4.0 * b * (6 * s + 9), 15.0 * b * s)
        out.append(("E composite_mip_fwd",
                    f"{b} rays x {s} (bound {bound_ms * 1e3:.2f} us)",
                    lambda args=args: render.composite_mip(*args, 1.0,
                                                           True)))
    for (b, s), keys in (((2048, 32), ("weights", "rgb")),
                         ((2048, 64), ("weights",)),
                         ((4096, 64), render.MIP_OUT_KEYS)):
        args = _mip_args(torch, g, b, s)
        shapes = ((b, s), (b, 3), (b,), (b,))
        grads = [torch.randn(sh, device="cuda", generator=g) if k in keys
                 else None for k, sh in zip(render.MIP_OUT_KEYS, shapes)]
        with torch.no_grad():
            acc = render.composite_mip(*args, 1.0, True)[2]
        n_cot = sum(c.numel() for c in grads if c is not None)
        # density, tdist, rgb read, d density and d rgb written an
        # interval; dirs and acc read a ray; the cotangents read
        bound_ms, _ = _bound(4.0 * (b * (9 * s + 5) + n_cot), 30.0 * b * s)
        out.append(("E' composite_mip_bwd",
                    f"{b} rays x {s}, cotangents {'+'.join(keys)} (bound "
                    f"{bound_ms * 1e3:.2f} us)",
                    lambda args=args, acc=acc, grads=grads:
                    render.composite_mip_backward(args, acc, grads, 1.0,
                                                  True)))
    return out


def cases(torch, run=None):
    """(kernel, case, fn) at the path's shapes, seeded; the corner-table
    wrappers at run length `run` where given (else the path's)."""
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

    kw = {} if run is None else {"run": run}
    out = []
    table = rand(6, 121, 161, 512).to(bf16)
    plane_uv = uniform_uv(3, 2 * 250 * 61)
    out.append(("A table_sample_fwd", "plane bf16->f32, view_offset=3",
                lambda: interpolate.table_sample(table, plane_uv, hw,
                                                 "zeros", f32, 3, **kw)))
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
                                                 f32, **kw)))
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

    # kernel A at the neo360 lift with the grid's own uv (a fixture
    # scene's source poses: the z cells of a pillar share corner rows), and
    # with every point in one cell (the rows stay in L2: the L2-to-SM
    # path and the writes alone); the lift's output written by a memset
    view = _fixture_view(torch)
    fast_uv = _lift_uv(torch, view, (64, 64, 32))
    out.append(("A table_sample_fwd", "neo360_fast lift bf16->bf16, grid uv",
                lambda: interpolate.table_sample(table[:3], fast_uv, hw,
                                                 "zeros", bf16, **kw)))
    grid_uv = _lift_uv(torch, view, (64, 64, 64))
    one_uv = torch.full_like(grid_uv, 0.1)
    for case, u in (("grid uv", grid_uv), ("one cell", one_uv)):
        out.append(("A table_sample_fwd", f"neo360 lift f32->f32, {case}",
                    lambda u=u: interpolate.table_sample(lift, u, hw,
                                                         "zeros", f32,
                                                         **kw)))
    lift_out = torch.empty(3, 64 ** 3, 512, device=dev)
    out.append(("(write)", "lift output zero_(), 1.61 GB written",
                lift_out.zero_))

    # the tri-plane and local gathers of one conditioned level, from its
    # world points: the fused kernels where the version has them, else
    # the unfused chain (world2camera, 3 + 1 kernel A, the sums and the
    # projections); flat two-scene tables for a stage step's scene 1
    for what, dt, n_rays, s, scene in (
            ("neo360 tile", f32, 256, 385, 0),
            ("neo360 tile", f32, 256, 129, 0),
            ("neo360 step", f32, 500, 385, 0),
            ("neo360 step", f32, 500, 129, 0),
            ("neo360_fast tile", bf16, 256, 61, 0),
            ("neo360_fast stage step, scene 1", bf16, 250, 61, 1)):
        planes = [rand(3 * (1 + scene), 121, 161, 512).to(dt)
                  for _ in range(3)]
        local = rand(6 * (1 + scene), 121, 161, 512).to(dt)
        fn = level_gathers(torch, view, planes, local,
                           _level_points(torch, view, n_rays, s), scene,
                           run)
        name = {f32: "f32", bf16: "bf16"}[dt]
        out.append(("level gathers", f"{what}, {n_rays} rays x {s} {name}",
                    fn))
        if dt == f32:   # kernel A per call of the unfused chain
            cam = _level_cam(torch, view, n_rays, s)
            uvs = {"plane xz zeros": (planes[0], cam[..., [0, 2]],
                                      "zeros"),
                   "local border": (local, local_uv(cam, view), "border")}
            for which, (t, u, mode) in uvs.items():
                # the uv, the rows the points touch and the output once;
                # a 4C-wide fold a point
                rows = _rows_read(t.shape, u, hw, mode, 0)
                points = u.shape[0] * u.shape[1]
                bound_ms, _ = _bound(u.numel() * 4 + rows * 512 * 4
                                     + points * 128 * 4, 2.0 * points * 512)
                case = (f"{which}, {what}, {n_rays} rays x {s} (bound "
                        f"{bound_ms:.4f} ms)")
                out.append(("A table_sample_fwd", case,
                            lambda t=t, u=u, mode=mode:
                            interpolate.table_sample(t, u, hw, mode, f32,
                                                     **kw)))
                out.append(("(plain) table_sample_reference", case,
                            lambda t=t, u=u, mode=mode:
                            interpolate.table_sample_reference(
                                t, u, hw, mode, f32)))
                out.append(("(F.grid_sample)", case,
                            _grid_sample_fns(torch, 128, f32, u, hw, mode)))
    # kernels G and G' (grid_sample_2d and its image gradient) at the
    # plane-sweep warp, an RGB image and PixelNeRF's latent at its finer
    # level's points; in a checkout before G the same calls run the
    # corner-table route (the image's table and A; A' dense and the
    # table's transpose). With a run length, G' alone through its wrapper
    from neo360_tpu_torch.core import geometry
    feat, proj, depths = _warp_case(torch, dev)
    pix_uv = _pixelnerf_uv(torch, view, 512, 129)
    latent = rand(3, 120, 160, 512)
    for case, image, u in (
            ("warp (3,60,80,32) f32, 128 depths", feat,
             geometry.homography_uv((60, 80), proj, depths)),
            ("rgb (3,240,320,3) f32", rand(3, 240, 320, 3),
             uniform_uv(3, 240 * 320)),
            ("PixelNeRF latent (3,120,160,512) f32, 3 x 512 x 129", latent,
             pix_uv),
            ("PixelNeRF latent (3,120,160,512) bf16, 3 x 512 x 129",
             latent.to(bf16), pix_uv)):
        cot = torch.randn(u.shape[:2] + image.shape[-1:], device=dev,
                          generator=g)
        if run is None:
            out.append(("G grid_sample_fwd", case,
                        lambda image=image, u=u:
                        interpolate.grid_sample_2d(image, u)))
            leaf = image.clone().requires_grad_()
            res = interpolate.grid_sample_2d(leaf, u)
            out.append(("G' grid_sample_bwd", case,
                        lambda leaf=leaf, res=res, cot=cot:
                        torch.autograd.grad(res, leaf, cot,
                                            retain_graph=True)))
        else:
            out.append(("G' grid_sample_bwd", case,
                        lambda image=image, u=u, cot=cot:
                        interpolate.grid_sample_2d_backward(
                            cot, u, image.shape, image.dtype, "zeros",
                            run=run)))
    return out


def local_uv(cam, view):
    """The local table's uv at camera points [fg | bg] (NV, 2M, 3), as the
    model computes them before its gather."""
    import torch

    from neo360_tpu_torch.core import geometry
    from neo360_tpu_torch.nn.resnet import latent_scaling
    focal, c = view["src_focal"], view["src_c"]
    uv = geometry.projection(cam, torch.stack([focal[0], -focal[0]])[None],
                             c[:1], cam.shape[0])
    m = cam.shape[1] // 2
    scale = latent_scaling((120, 160), cam.device) / torch.tensor(
        [320.0, 240.0], device=cam.device)
    return torch.cat([uv[:, :m], uv[:, m:]], 0) * scale - 1.0


def level_gathers(torch, view, planes, local, points, scene, run=None):
    """The call that gathers one level's tri-plane and local latents in
    the imported version of the port (at run length `run` where given:
    the fused wrappers called directly, as `NeRFTP._local_feats_pair`
    calls the local one)."""
    from types import SimpleNamespace

    from neo360_tpu_torch.core import geometry
    from neo360_tpu_torch.models.neo360 import NeRFTP
    from neo360_tpu_torch.ops import interpolate

    fg, bg = points
    poses, focal, c = view["src_poses"], view["src_focal"], view["src_c"]
    model = SimpleNamespace(num_src_views=3)
    hw, size = (120, 160), (320, 240)
    if run is not None:
        from neo360_tpu_torch.nn.resnet import latent_scaling
        scale = (latent_scaling(hw) / torch.tensor(size, dtype=torch.float32)
                 ).tolist()

        def fn():
            cam = geometry.world2camera(torch.cat([fg, bg], 0).reshape(
                1, -1, 3), poses, ns=3)
            interpolate.triplane_sample(planes, cam, hw, 3 * scene, run=run)
            interpolate.local_sample(local, cam, focal, c, scale, hw,
                                     6 * scene, run=run)
        return fn
    if hasattr(interpolate, "triplane_sample"):
        def fn():
            cam = geometry.world2camera(torch.cat([fg, bg], 0).reshape(
                1, -1, 3), poses, ns=3)
            interpolate.triplane_sample(planes, cam, hw, 3 * scene)
            NeRFTP._local_feats_pair(model, cam, focal, c, local, hw, size,
                                     6 * scene)
        return fn
    from neo360_tpu_torch.nn.triplane import index_grid_tables

    def fn():
        index_grid_tables(torch.cat([fg, bg], 0), planes, hw, poses, 3,
                          3 * scene)
        NeRFTP._local_feats_pair(model, fg, bg, poses, focal, c, local, hw,
                                 size, 6 * scene)
    return fn


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=ROOT)
    parser.add_argument("--only", default="",
                        help="comma-separated prefixes: time only the "
                        "cases whose kernel name starts with one")
    parser.add_argument("--sweep", action="store_true",
                        help="time the corner-table cases at every run "
                        f"length of {SWEEP_RUNS} instead")
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
    only = tuple(p for p in args.only.split(",") if p)
    if args.sweep:
        return sweep(torch, only)
    one = torch.zeros(1, device="cuda")
    floor, whole = device_us(torch, one.zero_)
    print(f"[times] launch floor (a 1-element zero_(), no kernel of the "
          f"port): device {sum(floor.values()):.2f} us/call"
          f"{'' if whole else LOST}")
    todo = vanilla_cases(torch) + mip_cases(torch)
    if not only or not all(p.startswith(("D", "E")) for p in only):
        todo += cases(torch)
    for kernel, case, fn in todo:
        if only and not kernel.startswith(only):
            continue
        try:
            per, whole = device_us(torch, fn)
        except ValueError as e:
            print(f"[times] {kernel} {case}: refused: {e}")
            continue
        parts = ", ".join(f"{short(k)} {v:.1f}" for k, v in sorted(
            per.items(), key=lambda kv: -kv[1]))
        print(f"[times] {kernel} {case}: device {sum(per.values()):.2f} "
              f"us/call ({parts}){'' if whole else LOST}; event "
              f"{_median_ms(fn, torch):.4f} ms")
    return 0


def sweep(torch, only=()) -> int:
    """Device time of kernel A's, the fused gathers' and kernel G''s
    cases (those of `only`, if given) at each run length, passed to the
    four entry points."""
    for run in SWEEP_RUNS:
        for kernel, case, fn in cases(torch, run):
            if not kernel.startswith(only or ("A ", "level", "G' ")):
                continue
            per, whole = device_us(torch, fn)
            parts = ", ".join(f"{short(k)} {v:.1f}" for k, v in sorted(
                per.items(), key=lambda kv: -kv[1]) if v >= 1.0)
            print(f"[sweep] {kernel} {case} run {run}: device "
                  f"{sum(per.values()):.1f} us/call ({parts})"
                  f"{'' if whole else LOST}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
