"""The readings that the limits in `limits/<cell>.json` are set from, at a
cell's own size (on the card, not in the benchmark's runs):

    python3 -m benchmark.control --workload <cell> --side program \
        --seeds 11 12 ...           # the lower reading: sound runs
    python3 -m benchmark.control --workload <cell> --side control \
        --seeds 21 22 23            # the upper: the reference in the
                                    # program's place, one precision down
    python3 -m benchmark.control --workload <cell> --side control \
        --fault half --seeds ...    # the upper: a fault planted in it

`program` runs the whole harness (run.run_cell) once per seed in one
process, with a short window (`--seconds`). `control` puts the
architecture's reference (its adapter's, architectures/) in the program's
place, computed in the precision below the configuration's (float32 ->
TF32, bfloat16 -> fp8 e4m3 with a per-tensor scale) or, with `--fault`,
in float32 with one of the adapter's `FAULTS` planted (NeO-360's: "half",
half of every ray batch left out, the loss the mean over the rest; "rgb",
every colour altered by 0.05 where it is produced; "band", the highest
band of every sample's positional encoding dropped). It follows the same
items (training: the first three; render: the rays of the sample, over
`--views` orbit views) and the float32 reference judges it as the
harness judges the program. One JSON line a seed: the numbers the check
reads.
"""

from __future__ import annotations

import argparse
import json
import sys

LOWER = {"float32": "tf32", "bfloat16": "fp8"}


def control_numbers(reg, name: str, seed: int, device, kind: str,
                    fault=None, n_views: int = 8, config_over=None):
    """(numbers, notes) of the control: the reference in `kind` precision,
    or with `fault`, in the program's place, against the reference."""
    import torch

    from benchmark import check, scenes, weights
    cell = reg.workload(name)
    config = dict(reg.config(cell["config"]), **(config_over or {}))
    mix = reg.traffic(cell["traffic"])
    if config_over and "img_wh" in config_over:
        mix["img_wh"] = config_over["img_wh"]
    arch = reg.architecture(config)
    if fault is not None and fault not in arch.FAULTS:
        raise ValueError(f"fault {fault!r}: {config['name']}'s reference "
                         f"plants {arch.FAULTS}")
    prog = arch.Program(config, seed, device, weights.derive(seed, 2))
    cfg, shapes, trained = prog.cfg, prog.shapes(), prog.trained_names()
    trainer = prog.trainer_kind()
    prog.free()
    w_all = weights.make(shapes, seed, device)
    params = {k: w_all[k] for k in trained}
    pool = arch.make_items(mix, seed, device, cfg)
    items = pool["items"]
    if pool["kind"] == "view":
        n_rays = pool["rays_per_item"]
        views = [i % len(items) for i in range(n_views)]
        v_ids, r_ids = check.render_sample(len(views), n_rays, seed)
        sel = torch.as_tensor(v_ids * n_rays + r_ids, device=device)
        rays = {k: torch.cat([items[i][k] for i in views]).to(device)
                .index_select(0, sel) for k in items[0]}
        setup = pool["setup"]
        if setup is not None:
            setup = scenes.to_device(setup, device)
        got = arch.reference_render(config, params, setup, rays, kind,
                                    fault)
        return check.render_numbers(got, arch.reference_render(
            config, params, setup, rays))
    gen_seed = weights.derive(seed, 2)
    got = arch.reference_train(config, params, trainer, items[:3],
                               gen_seed, device, kind, fault)
    want = arch.reference_train(config, params, trainer, items[:3],
                                gen_seed, device)
    return check.train_numbers(got, want)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--side", choices=("program", "control"), required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", default=None,
                   help="one of the architecture's FAULTS")
    p.add_argument("--views", type=int, default=8)
    p.add_argument("--over", default="{}",
                   help="configuration keys replaced, as JSON (a second "
                   "witness: {\"precision\": \"float32\"})")
    args = p.parse_args(argv)
    import torch

    from benchmark.registry import Registry
    from benchmark.run import run_cell
    reg = Registry()
    device = torch.device("cuda", 0)
    config = reg.config(reg.workload(args.workload)["config"])
    for seed in args.seeds:
        if args.side == "program":
            res = run_cell(reg, args.workload, seed, args.seconds, False,
                           device, json.loads(args.over) or None)
            out = {"correct": res["correct"], "numbers": res["numbers"]}
        else:
            kind = "f32" if args.fault else LOWER[config["precision"]]
            numbers, notes = control_numbers(
                reg, args.workload, seed, device, kind, args.fault,
                args.views, json.loads(args.over) or None)
            out = {"precision": kind, "fault": args.fault,
                   "numbers": numbers, "notes": notes}
        print(json.dumps(dict(workload=args.workload, side=args.side,
                              seed=seed, **out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
