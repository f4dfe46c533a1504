"""For the benchmark's CPU tests: a registry that adds the port's
production preset, whose stage trainer and proposal sampler the harness
drives but no cell of BENCHMARK.json does yet, and the cells' tiny sizes,
which each architecture's adapter gives (`tiny`, `tiny_sizes`)."""

import json
import shutil

import torch

from benchmark import scenes
from benchmark.registry import ROOT, Registry

STAGE_CELL = "neo360_fast.train_stage"
# the port's production preset (config.py's neo360_fast) and the stage
# trainer's feed: not a cell, since its widths are the port's own
PRODUCTION = {
    "name": "neo360_fast", "architecture": "neo360",
    "exp_type": "neo360_fast",
    "precision": "bfloat16", "tf32": None, "peak_flops": 989e12,
    "num_src_views": 3, "encoder": "resnet34_layer3",
    "encoder_channels": 512, "encoder_width": 512, "lift_dim": 128,
    "pillar_width": 512, "depth_fc_layers": 2, "grid_size": [64, 64, 32],
    "plane_hw": [120, 160], "plane_dim": 128, "local_proj_dim": 128,
    "mlp_depth": 4, "mlp_width": 128, "mlp_cond_depth": 2,
    "mlp_cond_width": 64, "prop_depth": 4, "prop_width": 128,
    "use_proposal": True, "num_prop_samples": 64, "num_fine_samples": 60,
    "ray_batch_size": 500, "trainer": "scene_stage", "stage_k": 32,
    "stage_scenes": 2, "remat_encoder": "preset"}
STAGE_MIX = {
    "name": "train_stage", "kind": "stage", "img_wh": [320, 240],
    "scenes_in_pool": 4, "train_views_per_scene": 100,
    "dest_views_per_sample": 20, "camera_radius": 8.0, "items_in_pool": 40}


def with_production(tmp_path) -> Registry:
    """BENCHMARK.json and the benchmark's folder copied under `tmp_path`,
    with the production preset and its stage cell added."""
    here = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (here / "configs" / "neo360_fast.json").write_text(
        json.dumps(PRODUCTION))
    (here / "traffic" / "train_stage.json").write_text(json.dumps(STAGE_MIX))
    (here / "limits" / f"{STAGE_CELL}.json").write_text(json.dumps(
        {"loss_gap": 0.027, "moment_gap_median": 0.05, "change_gap": 0.4}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "neo360_fast", "source": "test",
                             "file": "benchmark/configs/neo360_fast.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": STAGE_CELL, "config": "neo360_fast",
                               "traffic": "train_stage", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "train" in m["name"] and "workloads" in m:
            m["workloads"].append(STAGE_CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return Registry(root=tmp_path, here=here)

def adapter(reg: Registry, cell: str):
    """The adapter of the cell's configuration's architecture."""
    return reg.architecture(reg.config(reg.workload(cell)["config"]))


def tiny_over(cell: str) -> dict:
    """The configuration keys the cell's CPU tests replace (its adapter's
    `tiny_sizes`); the production preset's stage cell included."""
    reg = Registry()
    config = PRODUCTION if cell == STAGE_CELL else reg.config(
        reg.workload(cell)["config"])
    return reg.architecture(config).tiny_sizes(config)


# faults planted in the timed path once set-up has built it (run.run_cell's
# `fault`), through the adapter interface alone
def unchanged(prog):
    """A step that returns its state unchanged: every parameter put back
    after each item."""
    inner = prog.runner

    def run(item):
        live = prog.params()
        saved = {k: v.clone() for k, v in live.items()}
        out = inner(item)
        with torch.no_grad():
            for k, v in live.items():
                v.copy_(saved[k])
        return out
    prog.runner = run


def half_batch(prog):
    """Half of every ray batch left out; the loss is the mean over the
    rest."""
    inner = prog.runner
    keys = scenes.RAY_KEYS + ("target", "radii")

    def halved(item):
        n = item["rays_o"].shape[-2]
        return inner({k: v[..., :n // 2, :] if k in keys else v
                      for k, v in item.items()})
    prog.runner = halved


def altered(prog):
    """Every view's answer (its colours and depths) altered by 0.05 where
    the renderer produces it."""
    inner = prog.runner
    prog.runner = lambda rays: {k: v + 0.05 for k, v in inner(rays).items()}
