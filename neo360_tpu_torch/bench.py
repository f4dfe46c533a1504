"""Throughput benchmark of the port (the counterpart of the JAX package's
bench.py): NeO-360 train rays/s, full-view render rays/s with the encode
cached, and a per-op profile.

    python -m neo360_tpu_torch.bench                     # train, proposal
    python -m neo360_tpu_torch.bench --mode reference     # per-step neo360
    python -m neo360_tpu_torch.bench --phase render [--profile DIR]

Modes (the JAX bench.py reads them from NEO360_BENCH_* variables; here
they are flags, and README.md maps one to the other):
- proposal (default): the neo360_fast model (bf16, lift 128, encoder width
  512, grid (64, 64, 32), 64 proposal and 60 fine samples, no recompute)
  trained by the scene-mixed stage trainer, K=32 steps a stage over S=2
  scenes of `--rays` (500) rays a step;
- reference (`--mode reference`): the neo360 model (float32, the
  512-channel lift, grid 64^3, 128 coarse and 256 fine samples, the
  encoder's recompute) trained by the per-step trainer;
- `--phase render`: the mode's model encodes one scene (timed apart) and
  renders its full views in `--chunk`-ray tiles (make_image_renderer).
`--stage K` with K > 1 picks the stage trainer, else the per-step one, in
either mode, as the CLI does. Both train with Adam 5e-4 clipped to 0.05
(each partition of the stage trainer on its own), as bench.py does. The
model, optimizer and loss come from `cli.build_model`, `cli.
build_optimizer` and `cli.make_loss_fn` / `make_scene_stage_fns` on a
Config that the flags fill in.

Inputs: in-memory fixture scenes (data/fixtures.py:MemoryScenes) at
`--wh` (320 240) with 3 source views, rays drawn by the loader;
`--synthetic` takes `example_inputs` instead (random rays and poses, a
numpy copy of the JAX package's __graft_entry__._example_inputs). All of
it is drawn from `--seed` before the first window and placed on the
device.

Timing: the kernels are built (build_s), one warm-up window runs
(first_s), then `--repeats` windows, each closed by
torch.cuda.synchronize() on the host clock: a stage (stage trainer),
`--steps` steps (per-step trainer) or one view (render). Every window's
loss, or rendered view, must be finite (raises otherwise). `--profile DIR`
runs one more window under train/profiling.py:trace and prints its per-op
table (`profiling.summarize`) before the result.

The last line of standard output is one JSON object: metric, value
(rays/s at the median window), unit, median_s, min_s, max_s, n, first_s,
build_s, peak_gib (the device's peak allocated memory over the training
windows, or over the views), encode_s, encode_first_s and
encode_peak_gib (render), launches (each kernel's launches in the last
timed window), busy_share (with --profile), the device, the card's name
and power limit (nvidia-smi), and the knobs. On the CPU the metric's name
ends in "_on_cpu" instead of "_per_chip", and no device figure is given.

It runs on `--device` (default cuda: raises without a card, through
`cli.resolve_device`); `--device cpu` runs the kernels' plain versions,
for tests at tiny sizes.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from neo360_tpu_torch import cli
from neo360_tpu_torch.config import Config, preset
from neo360_tpu_torch.models.neo360 import SRC_KEYS, make_scene_stage_fns
from neo360_tpu_torch.ops import kernels
from neo360_tpu_torch.train import loop, profiling
from neo360_tpu_torch.train.pipeline import to_device

# Adam's constant learning rate and each partition's clip (bench.py:246)
LR, CLIP = 5e-4, 0.05


def example_inputs(n_rays: int = 64, nv: int = 3, hw=(48, 64),
                   seed: int = 0) -> Dict[str, np.ndarray]:
    """Random rays around the origin and `nv` source views on a sphere of
    radius 0.8 looking at it, float32 numpy arrays: the JAX package's
    __graft_entry__._example_inputs, draw for draw and bit for bit."""
    rng = np.random.default_rng(seed)
    h, w = hw
    o = rng.uniform(-0.2, 0.2, size=(n_rays, 3))
    d = rng.normal(size=(n_rays, 3))
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    poses = []
    for _ in range(nv):
        z = rng.normal(size=3)
        z /= np.linalg.norm(z)
        x = np.cross([0, 0, 1.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        m = np.eye(4)
        m[:3, 0], m[:3, 1], m[:3, 2] = x, y, z
        m[:3, 3] = z * 0.8
        poses.append(m)
    f32 = lambda a: np.asarray(a, np.float32)
    return {
        "rays_o": f32(o),
        "rays_d": f32(d),
        "viewdirs": f32(v),
        "radii": np.full((n_rays, 1), 1e-3, np.float32),
        "src_imgs": f32(rng.uniform(-1, 1, size=(nv, h, w, 3))),
        "src_poses": f32(np.stack(poses)),
        "src_focal": np.full((nv,), 50.0, np.float32),
        "src_c": np.tile(np.asarray([w / 2, h / 2], np.float32), (nv, 1)),
        "target": f32(rng.uniform(0, 1, size=(n_rays, 3))),
    }


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="NeO-360 train / render throughput of the port")
    p.add_argument("--mode", choices=("proposal", "reference"),
                   default="proposal")
    p.add_argument("--phase", choices=("train", "render"), default="train")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repeats", type=int, default=10,
                   help="timed windows after the warm-up one")
    p.add_argument("--steps", type=int, default=4,
                   help="steps a window of the per-step trainer")
    p.add_argument("--rays", type=int, default=None,
                   help="rays a training step (default: the preset's 500)")
    p.add_argument("--chunk", type=int, default=None,
                   help="rays a render tile (default: the preset's 256)")
    p.add_argument("--wh", type=int, nargs=2, default=(320, 240),
                   metavar=("W", "H"), help="scene and view size")
    p.add_argument("--synthetic", action="store_true",
                   help="example_inputs instead of fixture scenes")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace one more window into DIR and print its ops")
    p.add_argument("--top", type=int, default=40,
                   help="ops the profile table lists")
    # the model and trainer knobs of bench.py:115-146 (None: the mode's)
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                   default=None)
    p.add_argument("--remat", action=argparse.BooleanOptionalAction,
                   default=None, help="recompute the encoder's grid part")
    p.add_argument("--lift", type=int, default=None,
                   help="grid-lift width (0: the 512-channel lift)")
    p.add_argument("--encw", type=int, default=None, help="encoder width")
    p.add_argument("--pillw", type=int, default=None,
                   help="pillar hidden width (0: the encoder width)")
    p.add_argument("--depthl", type=int, default=None,
                   help="DepthPillarEncoder hidden layers")
    p.add_argument("--planed", type=int, default=None,
                   help="tri-plane channels")
    p.add_argument("--locald", type=int, default=None,
                   help="projected pixel-latent channels")
    p.add_argument("--grid", default=None, help="G or GX,GY,GZ")
    p.add_argument("--prop", type=int, default=None,
                   help="proposal samples (proposal mode)")
    p.add_argument("--coarse", type=int, default=None,
                   help="coarse samples (reference mode)")
    p.add_argument("--fine", type=int, default=None, help="fine samples")
    p.add_argument("--stage", type=int, default=None,
                   help="K steps a stage; <= 1: the per-step trainer")
    p.add_argument("--scenes", type=int, default=None,
                   help="S scenes a stage (default 2 with stages, else 1)")
    p.add_argument("--cot", choices=("f32", "bf16"), default="f32",
                   help="the stage trainer's cotangent accumulator")
    return p.parse_args(argv)


def config(args: argparse.Namespace) -> Config:
    """The Config of the mode's preset with the flags' overrides."""
    ref = args.mode == "reference"
    cfg = preset("neo360" if ref else "neo360_fast", seed=args.seed,
                 device=args.device, img_wh=tuple(args.wh),
                 lr_init=LR, lr_final=LR, lr_delay_steps=0,
                 grad_max_norm=CLIP, num_coarse_samples=args.coarse,
                 num_prop_samples=args.prop, encoder_width=args.encw,
                 plane_dim=args.planed, local_proj_dim=args.locald,
                 depth_fc_layers=args.depthl,
                 stage_cot_dtype={"f32": "float32",
                                  "bf16": "bfloat16"}[args.cot])
    over = {}
    if args.bf16 is not None:
        over["bf16"] = args.bf16
    if args.remat is not None:
        over["remat_encoder"] = args.remat
    if args.lift is not None:
        over["lift_dim"] = args.lift or None
    if args.pillw:
        over["pillar_width"] = args.pillw
    if args.grid is not None:
        g = [int(v) for v in args.grid.split(",")]
        over["grid_size"] = tuple(g * 3 if len(g) == 1 else g)
    if args.fine is not None:
        over["num_fine_samples"] = args.fine
    if args.stage is not None:
        over["stage_k"] = args.stage
    stage_k = over.get("stage_k", cfg.stage_k)
    over["stage_scenes"] = args.scenes or (2 if stage_k > 1 else 1)
    if args.rays is not None:
        over["ray_batch_size"] = args.rays
    if args.chunk is not None:
        over["chunk"] = args.chunk
    return cfg.replace(**over)


def knobs(cfg: Config, model, args) -> Dict:
    enc = model.encoder
    return {"mode": args.mode, "phase": args.phase,
            "exp_type": cfg.exp_type, "bf16": cfg.bf16,
            "lift": cfg.lift_dim, "encw": enc.latent_size,
            "pillw": enc.tri_pillar.f,
            "depthl": len(enc.depth_fc.hidden), "planed": enc.plane_dim,
            "locald": model.local_proj_fg_f.weight.shape[0],
            "grid": list(enc.grid_size), "remat": enc.remat,
            "prop": model.num_prop_samples if model.use_proposal else None,
            "coarse": (None if model.use_proposal
                       else model.num_coarse_samples),
            "fine": model.num_fine_samples, "stage": cfg.stage_k,
            "scenes": cfg.stage_scenes, "cot": args.cot,
            "rays": cfg.ray_batch_size, "chunk": cfg.chunk,
            "wh": list(cfg.img_wh), "synthetic": args.synthetic,
            "seed": cfg.seed}


def card(device: torch.device) -> Dict:
    """The card's name and power limit as nvidia-smi reports them."""
    if device.type != "cuda":
        return {"card": None, "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    name, power = smi.stdout.strip().splitlines()[0].rsplit(", ", 1)
    return {"card": name, "power_limit": power}


def _perturbed(rng, base: Dict[str, np.ndarray], keys) -> Dict:
    """`base`'s `keys` with a 1e-4 normal perturbation (bench.py:230)."""
    return {k: (base[k] + rng.standard_normal(base[k].shape) * 1e-4
                ).astype(np.float32) for k in keys}


def _scenes(cfg: Config, n_scenes: int, split: str):
    from neo360_tpu_torch.data.fixtures import MemoryScenes
    return MemoryScenes(max(n_scenes, 1), cfg.img_wh, cfg.num_src_views,
                        split=split, ray_batch_size=cfg.ray_batch_size)


def _stage_windows(cfg: Config, n: int, synthetic: bool) -> List:
    """n stages: (src, rays) dicts of numpy arrays, src (S, NV, ...) and
    rays (K, S, B/S, ...) with S > 1, else (NV, ...) and (K, B, ...)."""
    k, s, b = cfg.stage_k, cfg.stage_scenes, cfg.ray_batch_size
    rays_keys = cli.STAGE_RAY_KEYS
    if not synthetic:
        ds = _scenes(cfg, s, "train")
        rng = np.random.default_rng(cfg.seed)
        stages = [ds.sample_train_stage(rng, k, n_scenes=s)
                  for _ in range(n)]
        return [({key: st[key] for key in SRC_KEYS},
                 {key: st[key] for key in rays_keys}) for st in stages]
    w, h = cfg.img_wh
    base = example_inputs(n_rays=b, hw=(h, w), seed=cfg.seed)
    src = {key: np.stack([base[key]] * s) if s > 1 else base[key]
           for key in SRC_KEYS}
    rng = np.random.default_rng(cfg.seed + 1)
    out = []
    for _ in range(n):
        steps = [_perturbed(rng, base, rays_keys) for _ in range(k)]
        rays = {key: np.stack([st[key] for st in steps]) for key in rays_keys}
        if s > 1:
            rays = {key: v.reshape((k, s, b // s) + v.shape[2:])
                    for key, v in rays.items()}
        out.append((src, rays))
    return out


def _step_windows(cfg: Config, n: int, steps: int, synthetic: bool) -> List:
    """n windows of `steps` stacked per-step batches (cli.STEP_KEYS)."""
    if not synthetic:
        ds = _scenes(cfg, cfg.stage_scenes, "train")
        rng = np.random.default_rng(cfg.seed)
        return [loop.stack_batches([ds.sample_train(rng)
                                    for _ in range(steps)], cli.STEP_KEYS)
                for _ in range(n)]
    w, h = cfg.img_wh
    base = example_inputs(n_rays=cfg.ray_batch_size, hw=(h, w),
                          seed=cfg.seed)
    rng = np.random.default_rng(cfg.seed + 1)
    rays_keys = cli.STAGE_RAY_KEYS
    return [loop.stack_batches([dict({k: base[k] for k in SRC_KEYS},
                                     **_perturbed(rng, base, rays_keys))
                                for _ in range(steps)], cli.STEP_KEYS)
            for _ in range(n)]


def _view_windows(cfg: Config, n: int, synthetic: bool):
    """(the source stack, n views' rays) of one scene."""
    w, h = cfg.img_wh
    if synthetic:
        base = example_inputs(n_rays=1, hw=(h, w), seed=cfg.seed)
        full = example_inputs(n_rays=w * h, hw=(h, w), seed=cfg.seed + 1)
        return ({k: base[k] for k in SRC_KEYS},
                [{k: full[k] for k in cli.RAY_KEYS}] * n)
    ds = _scenes(cfg, 1, "test")
    views = [ds.sample_test(0, i % ds.num_test_views(0)) for i in range(n)]
    return ({k: views[0][k] for k in SRC_KEYS},
            [{k: v[k] for k in cli.RAY_KEYS} for v in views])


class _Clock:
    """Host-clock windows closed by a device synchronize, and the kernels'
    launches in each (`kernels.launches`)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def window(self, fn: Callable):
        """(seconds, {C entry: its launches in the window} over the
        entries launched, fn's result)."""
        before = dict(kernels.launches)
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        seconds = time.perf_counter() - t0
        launches = {k: n - before[k] for k, n in kernels.launches.items()
                    if n != before[k]}
        return seconds, launches, out


def _peak_gib(device: torch.device) -> Optional[float]:
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _train_fn(cfg: Config, model, device, windows):
    """fn(i) -> metrics: window i of the stage or per-step trainer."""
    generator = torch.Generator(device).manual_seed(cfg.seed + 2)
    make_opt = lambda params: cli.build_optimizer(cfg, params)
    if cfg.stage_k > 1:
        encode_fn, loss_fn = make_scene_stage_fns(
            model, cfg.white_back, mixed=cfg.stage_scenes > 1)
        state = loop.create_scene_stage_state(model, make_opt)
        runner = loop.make_scene_stage_trainer(
            encode_fn, loss_fn, cot_dtype=getattr(torch, cfg.stage_cot_dtype))
        return lambda i: runner(state, *windows[i], generator)
    state = loop.create_train_state(model, make_opt)
    runner = loop.make_staged_trainer(loop.make_train_step(
        cli.make_loss_fn(cfg, model), with_model_state=True))
    return lambda i: runner(state, windows[i], generator)


def _check_finite(what: str, tensors) -> None:
    for k, v in tensors.items():
        if not bool(torch.isfinite(v).all()):
            raise FloatingPointError(f"{what}: non-finite {k}")


def run(args: argparse.Namespace) -> Dict:
    """The benchmark (module docstring); returns the result line's
    object."""
    if args.repeats < 1 or args.steps < 1:
        raise ValueError("--repeats and --steps must be at least 1")
    cfg = config(args)
    device = cli.resolve_device(cfg)
    cli.float32_matmuls(cfg, device)
    clock = _Clock(device)
    build_s = None
    if device.type == "cuda":
        t0 = time.perf_counter()
        kernels.build()
        kernels.library()
        build_s = time.perf_counter() - t0
    model = cli.build_model(cfg, device)
    n = 1 + args.repeats + (1 if args.profile else 0)
    result = {}
    if args.phase == "train":
        if cfg.stage_k > 1:
            windows = _stage_windows(cfg, n, args.synthetic)
            rays = cfg.stage_k * cfg.ray_batch_size
        else:
            windows = _step_windows(cfg, n, args.steps, args.synthetic)
            rays = args.steps * cfg.ray_batch_size
        windows = to_device(windows, device)
        model.train()
        step = _train_fn(cfg, model, device, windows)

        def window(i):
            metrics = step(i)
            _check_finite(f"training window {i}", metrics)
            return metrics
        what = "train"
    else:
        src, views = _view_windows(cfg, n, args.synthetic)
        src, views = to_device((src, views), device)
        rays = cfg.img_wh[0] * cfg.img_wh[1]
        batch_stats = cfg.eval_bn_mode == "batch"
        encode = lambda: model.encode(*(src[k] for k in SRC_KEYS),
                                      batch_stats)
        _reset_peak(device)
        with torch.inference_mode():
            first, _, _ = clock.window(encode)
            seconds, _, enc = clock.window(encode)
        result.update(encode_first_s=first, encode_s=seconds,
                      encode_peak_gib=_peak_gib(device))

        def render_chunk(pack, chunk):
            out = model(dict(chunk, **src), pack, cfg.white_back,
                        out_depth=True)[1]
            return {"rgb": out["rgb"], "depth": out["depth"]}

        renderer = loop.make_image_renderer(render_chunk, cfg.chunk)

        def window(i):
            out = renderer(enc, views[i])
            _check_finite(f"view {i}", out)
            if out["rgb"].shape != (rays, 3):
                raise ValueError(f"view {i}: rgb {tuple(out['rgb'].shape)}")
            return out
        what = "render"

    _reset_peak(device)
    first_s, _, _ = clock.window(lambda: window(0))
    times, launches = [], {}
    for i in range(1, 1 + args.repeats):
        seconds, launches, _ = clock.window(lambda: window(i))
        times.append(seconds)
    median = statistics.median(times)
    peak = _peak_gib(device)
    if args.profile:
        with profiling.trace(args.profile) as prof:
            _, traced, _ = clock.window(lambda: window(n - 1))
        summary = profiling.summarize(prof, args.top, median, traced)
        result["busy_share"] = summary["busy_share"]
    per = "per_chip" if device.type == "cuda" else "on_cpu"
    return {"metric": f"neo360_{what}_rays_per_sec_{per}",
            "value": rays / median, "unit": "rays/s", "median_s": median,
            "min_s": min(times), "max_s": max(times), "n": len(times),
            "first_s": first_s, "build_s": build_s, "peak_gib": peak,
            **result, "launches": launches, "device": str(device),
            **card(device), "knobs": knobs(cfg, model, args)}


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
