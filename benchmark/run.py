"""One run of one benchmark cell:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. All the
run knows of the configuration's architecture it takes from that
architecture's adapter (architectures/, registry.py). Set-up (counted in
`setup_s`, from the process's start) loads the port's kernel library
(built into build/neo360_kernels/ by the first run in a checkout), builds
the adapter's program for the configuration, makes its weights and the
mix's items on the card from the seed, and runs the first items, which
warm every shape up: a training cell's first three items (the check
follows them), a render cell's set-up (a few-shot model's encode) and
first view. The window then runs items closed-loop, one after the other, each
copied to the card and waited for, until `--seconds` have passed; it ends
on a whole item, and a rate is every ray of the window over its seconds.
With `--trace 1` the end-to-end metrics give way to the per-layer ones
and one more item runs under the profiler. Then the program's state is
freed and the adapter's plain reference checks what the timed path
produced (check.py). Standard error ends with the numbers compared and their
limits; the last line of standard output is the result, one JSON object.

The run fails (exit code not 0, no result) without the cards the cell
asks for, and if JAX, flax or the JAX package `neo360_tpu` is loaded once
the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "neo360_tpu")
CACHE = ROOT / "build" / "benchmark_cache"


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is a JAX one, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_info(torch) -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "power_limit": (smi.stdout.strip().splitlines()
                                        or ["not read"])[0]}


def run_cell(reg, name: str, seed: int, seconds: float, trace_on: bool,
             device, config_over=None, fault=None) -> dict:
    """The run's result, without the device's name (main adds it).
    `config_over`: configuration keys replaced (the CPU tests' tiny
    sizes); `fault`: a callable that breaks the timed path once set-up
    has built it (the fault tests)."""
    import torch

    from benchmark import check, scenes, trace, weights
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cell = reg.workload(name)
    config = dict(reg.config(cell["config"]), **(config_over or {}))
    mix = reg.traffic(cell["traffic"])
    if config_over and "img_wh" in config_over:
        mix["img_wh"] = config_over["img_wh"]
    limits = reg.limits(name)
    arch = reg.architecture(config)
    parts = {"import": time.perf_counter() - T0}
    clock = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        parts[what] = now - clock[0]
        clock[0] = now

    if cuda:
        arch.kernel_library()
    lap("library")
    prog = arch.Program(config, seed, device, weights.derive(seed, 2))
    cfg = prog.cfg
    lap("model")
    w_all = weights.make(prog.shapes(), seed, device)
    prog.load(w_all)
    trained = prog.trained_names()
    lap("weights")
    trainer = prog.trainer_kind()
    pool = arch.make_items(mix, seed, device, cfg)
    kind, items = pool["kind"], pool["items"]
    lap("scenes")
    outs, out_items, first = [], [], 0
    if kind == "view":
        setup = pool["setup"]
        if setup is not None:
            setup = scenes.to_device(setup, device)
        prog.make_renderer(setup)
        lap("encode")
        if fault:
            fault(prog)
        outs.append(prog.runner(scenes.to_device(items[0], device)))
        out_items.append(0)
        first = 1
    else:
        prog.make_trainer()
        if fault:
            fault(prog)
        prog.recording = True
        for i in range(3):
            prog.runner(scenes.to_device(items[i], device))
            if i == 0:
                moments_p = check.norms(prog.moments())
        params = prog.params()
        change_p = check.norms({k: params[k] - w_all[k] for k in trained})
        losses_p = [float(x) for x in prog.recorded]
        prog.recording = False
        prog.recorded = []
        first = 3
    sync()
    lap("warm-up")
    setup_s = time.perf_counter() - T0
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # ------------------------------------------------------------- window
    done, health, ends = 0, [], []
    t_start = time.perf_counter()
    while True:
        idx = (first + done) % len(items)
        out = prog.runner(scenes.to_device(items[idx], device))
        if kind == "view":
            outs.append(out)
            out_items.append(idx)
        else:
            health.append(next(iter(out.values())))
        sync()
        done += 1
        ends.append(time.perf_counter() - t_start)
        if ends[-1] >= seconds:
            break
    window_s = time.perf_counter() - t_start
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    tr = None
    if trace_on:
        idx = (first + done) % len(items)
        tr = trace.profile(
            lambda: prog.runner(scenes.to_device(items[idx], device)), sync)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded once the window closed: {found}")
    memory_peak = max(peak_setup, torch.cuda.max_memory_allocated(device)
                      if cuda else 0)
    if kind == "view":
        failed = sum(not bool(torch.isfinite(o["rgb"]).all())
                     for o in outs[first:])
    else:
        failed = sum(not bool(torch.isfinite(h).all()) for h in health)

    # ---------------------------------------------------------- reference
    prog.free()
    del health
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    params = {k: w_all[k] for k in trained}
    if kind == "view":
        n_rays = pool["rays_per_item"]
        v_ids, r_ids = check.render_sample(len(outs), n_rays, seed)
        sel = torch.as_tensor(v_ids * n_rays + r_ids, device=device)
        got = {k: torch.cat([o[k] for o in outs]).index_select(0, sel)
               for k in ("rgb", "depth")}
        rays = {k: torch.cat([items[i][k] for i in out_items]).to(device)
                .index_select(0, sel) for k in items[0]}
        del outs
        numbers, notes = check.render_numbers(got, arch.reference_render(
            config, params, setup, rays))
    else:
        ref_out = arch.reference_train(
            config, params, trainer, items[:3], weights.derive(seed, 2),
            device)
        numbers, notes = check.train_numbers(
            {"losses": losses_p, "moments": moments_p, "change": change_p},
            ref_out)
    parts["reference (not set-up)"] = time.perf_counter() - t_ref
    verdict = check.judge(numbers, limits)
    log("[numbers] " + json.dumps(numbers))
    log("[notes] " + json.dumps(notes))

    # ------------------------------------------------------------ metrics
    rays_item = pool["rays_per_item"]
    rate = rays_item * done / window_s
    wk = arch.work(config, mix, cfg)
    ctx = {"kind": kind, "items": done, "window_s": window_s,
           "steps_per_item": pool["steps_per_item"], "work": wk,
           "flops_item": arch.item_flops(wk),
           "peak_flops": config["peak_flops"], "trace": tr,
           "peak_bytes": peak_window,
           "families": reg.families(arch.FAMILIES)}
    metrics = {}
    for m in reg.metrics(name, trace_on):
        if m["name"] == "setup_s":
            value = setup_s
        elif m["name"].endswith("rays_per_s"):
            value = rate
        else:
            value = reg.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": verdict["correct"], "attempted": done,
              "failed": int(failed), "metrics": metrics,
              "device": {"memory_peak_bytes": int(memory_peak)}}
    if tr is not None:
        result["device"].update(busy_s=tr["busy_s"],
                                window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["numbers"] = numbers
    result["checks"] = verdict["checks"]
    log(f"[window] {done} items of {rays_item} rays in {window_s:.4f} s; "
        "item seconds " + " ".join(
            f"{b - a:.4f}" for a, b in zip([0.0] + ends, ends)))
    log("[setup] " + " ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    import torch
    from benchmark.registry import Registry
    reg = Registry()
    chips = reg.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    result = run_cell(reg, args.workload, args.seed, args.seconds,
                      bool(args.trace), device)
    result["device"] = dict(card_info(torch), **result["device"])
    del result["numbers"]
    result["checks"] = result.pop("checks")
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']} limit {c['limit']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
