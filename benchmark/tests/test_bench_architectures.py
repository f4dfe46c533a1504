"""Architectures behind adapters, on the CPU.

A second architecture from new files only: a copy of the benchmark's
folder and BENCHMARK.json (under `tmp_path`) takes vanilla NeRF as a later
architecture would come, from the files under `second_architecture/`
(an adapter driving the port's `vanilla` preset, its configuration, a
"rays" and an "image" mix, limits and one roofline family) and the
BENCHMARK.json entries of a train and a view cell. This is a plumbing
check, not a correctness reference: the vanilla adapter's reference is
the port's own model on its plain path, built apart from the program, so
it shows that the shared harness runs the cells, judges them, fails them
when the timed path is broken and runs their control, all with every
file that was there before byte for byte unchanged.

The per-scene mixes: an "image" item is a "view" item's rays with their
cones' radii (as the port computes them) and no source stack; a "rays"
item is B rays of scene 0's train cameras.

NeO-360 as at the parent: both cells of BENCHMARK.json and the
production preset's stage cell (support.with_production) at their tiny
sizes, one seed, one window item and one CPU thread give the `numbers`
and the digests of the items (`make_items`) that the parent commit gave
before the harness was split into adapters.
"""

import hashlib
import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import scenes
from benchmark.check import judge
from benchmark.control import control_numbers
from benchmark.registry import ROOT, Registry
from benchmark.run import run_cell
from benchmark.tests.support import (STAGE_CELL, adapter, altered,
                                     half_batch, unchanged, with_production)

NEW = Path(__file__).resolve().parent / "second_architecture"
TRAIN, VIEW = "vanilla.train_rays", "vanilla.render_image"
# the metrics of existing cells that a vanilla cell reports too (it has
# no encoder and no gathers: encoder_ and gather_device_ms read nothing)
NOT_REPORTED = {"encoder_device_ms.train", "gather_device_ms.render"}
SEED = 3_000_000_019
CPU = torch.device("cpu")


def add_vanilla(tmp_path):
    """(registry, the pre-existing files' bytes) of a copy of the
    benchmark with vanilla added from new files and entries."""
    here = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    for src in NEW.rglob("*"):
        if src.is_file() and "__pycache__" not in src.parts:
            dest = here / src.relative_to(NEW)
            assert not dest.exists(), dest          # new files only
            dest.write_bytes(src.read_bytes())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(
        {"name": "vanilla", "source": "https://arxiv.org/abs/2003.08934",
         "file": "benchmark/configs/vanilla.json", "reduced": [],
         "why": "a second architecture: per-scene, no encoder"})
    bench["workloads"] += [
        {"name": TRAIN, "config": "vanilla", "traffic": "train_rays",
         "chips": 1, "why": "per-scene steps of B rays"},
        {"name": VIEW, "config": "vanilla", "traffic": "render_image",
         "chips": 1, "why": "whole orbit views, no source stack"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and m["name"] not in NOT_REPORTED:
            m["workloads"].append(TRAIN if "train" in m["name"] else VIEW)
    bench_file = tmp_path / "BENCHMARK.json"
    bench_file.write_text(json.dumps(bench))
    return Registry(root=tmp_path, here=here), before


def tiny_run(reg, cell, fault=None, trace=True):
    config = reg.config(reg.workload(cell)["config"])
    with adapter(reg, cell).tiny(config) as over:
        return run_cell(reg, cell, SEED, 0.3, trace, CPU, over, fault)


def test_a_second_architecture_from_new_files_only(tmp_path):
    reg, before = add_vanilla(tmp_path)
    arch = adapter(reg, TRAIN)
    assert arch.__file__ == str(tmp_path / "benchmark" / "architectures"
                                / "vanilla.py")
    for cell in (TRAIN, VIEW):
        res = tiny_run(reg, cell)
        assert res["correct"], res["checks"]
        assert res["failed"] == 0 and res["attempted"] >= 1
        want = {m["name"] for m in reg.metrics(cell, True)}
        assert {"mfu.train" if cell == TRAIN else "mfu.render",
                "peak_gib.train" if cell == TRAIN else "peak_gib.render"} \
            <= want
        assert set(res["metrics"]) <= want
        assert set(tiny_run(reg, cell, trace=False)["metrics"]) == {
            m["name"] for m in reg.metrics(cell, False)}
    for fault in (unchanged, half_batch):
        assert not tiny_run(reg, TRAIN, fault)["correct"], fault
    assert not tiny_run(reg, VIEW, altered)["correct"]
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_the_second_architectures_control_runs(tmp_path):
    reg, before = add_vanilla(tmp_path)
    for cell, fault in ((TRAIN, "half"), (VIEW, "rgb")):
        config = reg.config(reg.workload(cell)["config"])
        with adapter(reg, cell).tiny(config) as over:
            low, _ = control_numbers(reg, cell, SEED, CPU, "tf32",
                                     n_views=2, config_over=over)
            bad, _ = control_numbers(reg, cell, SEED, CPU, "f32", fault,
                                     n_views=2, config_over=over)
            with pytest.raises(ValueError):
                control_numbers(reg, cell, SEED, CPU, "f32", "band",
                                n_views=2, config_over=over)
        assert set(reg.limits(cell)) <= set(low) == set(bad)
        assert not judge(bad, reg.limits(cell))["correct"], bad
    for p, data in before.items():
        assert p.read_bytes() == data, p


# ------------------------------------------------------ per-scene mixes
MIX = {"name": "m", "img_wh": [40, 30], "scenes_in_pool": 2,
       "train_views_per_scene": 48, "camera_radius": 8.0, "orbit_views": 3,
       "items_in_pool": 4, "dest_views_per_sample": 5}


def test_an_image_is_a_view_with_radii_and_no_source_stack():
    """The "image" kind draws the "view" kind's rays, in its order, with
    each pixel's cone radius as the port computes it from its camera."""
    from neo360_tpu_torch.core.rays import rays_for_camera
    view = scenes.make_items(dict(MIX, kind="view"), SEED, CPU, 3)
    image = scenes.make_items(dict(MIX, kind="image"), SEED, CPU, 3)
    assert view["setup"] is not None and image["setup"] is None
    assert image["kind"] == "view" and image["rays_per_item"] == 1200
    pool = scenes.ScenePool(SEED, 2, 48, (40, 30), 8.0, CPU, 3)
    for v, i in zip(view["items"], image["items"]):
        assert set(i) == set(v) | {"radii"}
        for k in v:
            assert torch.equal(v[k], i[k]), k
        assert i["radii"].shape == (1200, 1)
    port = rays_for_camera(30, 40, pool.focal, pool.orbit[0][0])["radii"]
    assert torch.allclose(image["items"][0]["radii"], port, rtol=1e-4)


def test_rays_are_one_scenes_train_rays_with_radii():
    pool = scenes.make_items(dict(MIX, kind="rays"), SEED, CPU, 0,
                             rays_per_step=7)
    assert pool["kind"] == "step" and pool["setup"] is None
    assert pool["rays_per_item"] == 7 and len(pool["items"]) == 4
    scene = scenes.ScenePool(SEED, 2, 48, (40, 30), 8.0, CPU, 3)
    centres = scene.poses[0][:, :3, 3]
    for item in pool["items"]:
        assert set(item) == {"rays_o", "rays_d", "viewdirs", "target",
                             "radii"}
        assert all(v.shape[0] == 7 for v in item.values())
        # every ray leaves a train camera of scene 0
        gap = (item["rays_o"][:, None] - centres[None]).abs().amax(-1)
        assert bool((gap.amin(1) == 0).all())
    again = scenes.make_items(dict(MIX, kind="rays"), SEED, CPU, 0,
                              rays_per_step=7)
    assert all(torch.equal(a[k], b[k]) for a, b in
               zip(pool["items"], again["items"]) for k in a)


# ------------------------------------------------- NeO-360 as at the parent
PARENT = "bab6e131be7cd759b725534aaec06cfa418638f2"
# run_cell's numbers and the items' digest at the parent commit above, on
# the CPU (x86-64, one thread), seed 3_000_000_019, 0 s (one window item),
# no trace, the sizes of support.tiny_over
AT_PARENT = {
    "neo360.train_step": (
        {"loss_gap": 0.00011908029842233711,
         "loss_gap_first": 1.3667184379610965e-07,
         "moment_gap": 8.399399557677522e-05,
         "moment_gap_median": 1.1216787336539709e-05,
         "change_gap": 0.004194664440781993,
         "change_gap_median": 0.00030904741013864333},
        "50759955b506dc693b5bc4dae5684521dd4f283f6c52af307e0453aee84816ce"),
    "neo360.render_view": (
        {"rgb_gap": 2.5331974029541016e-06,
         "rgb_p99_gap": 7.748603820800781e-07,
         "rgb_p50_gap": 8.940696716308594e-08,
         "rgb_mean_gap": 1.3236318352483067e-07,
         "depth_gap": 2.294778823852539e-06,
         "depth_p99_gap": 1.1326374078635126e-06,
         "depth_p50_gap": 8.940696716308594e-08,
         "depth_mean_gap": 1.558102695753405e-07},
        "21ac2655293c62a9b762bdcd997f6c1bdb29ac29c3cf83baf6788aae1541db00"),
    STAGE_CELL: (
        {"loss_gap": 0.0006064589538365998, "loss_gap_first": 0.0,
         "moment_gap": 0.0003412023365641173,
         "moment_gap_median": 1.209652052997296e-05,
         "change_gap": 0.001988550094194953,
         "change_gap_median": 9.683752952065816e-05},
        "712a3ef5666a16261af02d92b3257f8d51dcdfd4e4f2b08987bb6aaecb0ffd77"),
}


def digest(pool) -> str:
    """sha256 over every item's tensors (keys sorted), then the setup's."""
    h = hashlib.sha256()
    setup = [pool["setup"]] if pool["setup"] is not None else []
    for d in pool["items"] + setup:
        for k in sorted(d):
            t = d[k].contiguous()
            for part in (k, str(t.dtype), str(tuple(t.shape))):
                h.update(part.encode())
            h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("cell", sorted(AT_PARENT))
def test_neo360_reads_as_at_the_parent(cell, tmp_path, monkeypatch,
                                       one_thread):
    reg = with_production(tmp_path)
    arch = adapter(reg, cell)
    pools = []
    make_items = arch.make_items
    monkeypatch.setattr(arch, "make_items",
                        lambda *a: pools.append(make_items(*a)) or pools[-1])
    config = reg.config(reg.workload(cell)["config"])
    with arch.tiny(config) as over:
        res = run_cell(reg, cell, SEED, 0, False, CPU, over)
    numbers, items = AT_PARENT[cell]
    assert res["attempted"] == 1
    assert res["numbers"] == numbers
    assert digest(pools[0]) == items
