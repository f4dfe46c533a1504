#!/usr/bin/env python3
"""Device time and kernel launches of the PyTorch port's render path on
one NVIDIA GPU, per 256-ray tile, at full width with seeded random
weights.

    python3 scripts/torch_render_profile.py [--tree DIR] [--tiles N]

For each preset (neo360_fast, neo360) the model encodes one in-memory
320x240 fixture scene, renders one warm-up tile, then renders `--tiles`
tiles (default 16) of a novel view through cli.make_render_fn under
torch.profiler (chip_smoke.py's `_profile`: device time, launches, busy
share, top kernels and ops). The last lines give device ms and launches
per tile. `--tree DIR` imports neo360_tpu_torch from DIR (another
checkout, unpacked with `git archive`), so that two versions can be
compared in one run on one card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import SEED, _profile  # noqa: E402


def render_tiles(torch, exp_type: str, tiles: int):
    """(device ms, launches) of `tiles` render tiles of `exp_type`."""
    from torch.profiler import ProfilerActivity, profile

    from neo360_tpu_torch import cli
    from neo360_tpu_torch.config import preset
    from neo360_tpu_torch.data.fixtures import MemoryScenes

    cfg = preset(exp_type, seed=SEED)
    dev = torch.device("cuda")
    cli.float32_matmuls(cfg, dev)
    model = cli.build_model(cfg, dev)
    sample = dict(MemoryScenes(1, cfg.img_wh, cfg.num_src_views)
                  .sample_test(0, 1), scene_key=0)
    render = cli.make_render_fn(cfg, model, dev)

    def part(n):
        return dict(sample, **{k: sample[k][:n * cfg.chunk]
                               for k in cli.RAY_KEYS})

    render(part(1))      # encode (cached) and warm-up
    label = f"{exp_type} render, {tiles} tiles of {cfg.chunk} rays"
    _profile(torch, lambda: render(part(tiles)), label, top=12)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        render(part(tiles))
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in rows) / 1e3,
            sum(e.count for e in rows))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=ROOT)
    parser.add_argument("--tiles", type=int, default=16)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_render_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import neo360_tpu_torch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(f"[render] {card.strip()}; package "
          f"{os.path.dirname(neo360_tpu_torch.__file__)}")
    for exp_type in ("neo360_fast", "neo360"):
        ms, launches = render_tiles(torch, exp_type, args.tiles)
        print(f"[render] {exp_type}: {ms / args.tiles:.3f} device ms and "
              f"{launches / args.tiles:.1f} launches per tile ({ms:.3f} ms, "
              f"{launches} launches in {args.tiles} tiles)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
