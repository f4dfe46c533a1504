"""Tiny sizes for the benchmark's CPU tests: the cells' configurations
cut to widths and grids the CPU runs in seconds (float32: the CPU's bf16
convolutions are not deterministic at some shapes), seeded weights by the
port's parameter names, and scenes from the benchmark's own generator;
and a registry that adds the port's production preset, whose stage
trainer and proposal sampler the harness drives but no cell of
BENCHMARK.json does yet."""

import json
import shutil

import torch

from benchmark import scenes, weights
from benchmark.registry import ROOT, Registry

STAGE_CELL = "neo360_fast.train_stage"
# the port's production preset (config.py's neo360_fast) and the stage
# trainer's feed: not a cell, since its widths are the port's own
PRODUCTION = {
    "name": "neo360_fast", "exp_type": "neo360_fast",
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

TINY = {"grid_size": [8, 8, 4], "encoder_width": 64, "pillar_width": 64,
        "num_prop_samples": 8, "num_coarse_samples": 8,
        "num_fine_samples": 6, "ray_batch_size": 16, "plane_hw": [30, 40],
        "precision": "float32", "img_wh": [40, 30]}


def tiny_over(cell: str) -> dict:
    over = dict(TINY)
    if cell == STAGE_CELL:
        over["lift_dim"] = 32
    return over


def tiny_weights(cfg: dict, seed: int = 5) -> dict:
    """Seeded weights of a port NeRFTP built at `cfg`'s sizes."""
    from neo360_tpu_torch.models.neo360 import NeRFTP
    from neo360_tpu_torch.nn.triplane import GridEncoder
    saved = GridEncoder.plane_hw
    GridEncoder.plane_hw = tuple(cfg["plane_hw"])
    try:
        model = NeRFTP(num_src_views=cfg["num_src_views"],
                       grid_size=tuple(cfg["grid_size"]),
                       encoder_width=cfg["encoder_width"],
                       lift_dim=cfg["lift_dim"],
                       pillar_width=cfg["pillar_width"],
                       plane_dim=cfg["plane_dim"],
                       local_proj_dim=cfg["local_proj_dim"],
                       use_proposal=cfg["use_proposal"],
                       num_prop_samples=cfg["num_prop_samples"],
                       num_coarse_samples=cfg["num_coarse_samples"],
                       num_fine_samples=cfg["num_fine_samples"])
    finally:
        GridEncoder.plane_hw = saved
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    return weights.make(shapes, seed, "cpu")


def tiny_scene(nv: int, w: int, h: int, n_rays: int, seed: int = 3):
    pool = scenes.ScenePool(seed, 1, 12, (w, h), 8.0, "cpu")
    gen = torch.Generator().manual_seed(seed)
    view = torch.randint(nv, 12, (n_rays,), generator=gen).numpy()
    xs = torch.randint(0, w, (n_rays,), generator=gen).numpy()
    ys = torch.randint(0, h, (n_rays,), generator=gen).numpy()
    rays = pool.dest_rays(0, view, xs, ys)
    return pool.source_stack(0, range(nv)), {k: rays[k]
                                            for k in scenes.RAY_KEYS}
