"""The `pixelnerf.train_step` cell on the CPU (run.run_cell with the
port's plain versions, at its adapter's tiny sizes): a sound run is
correct against benchmark/reference/pixelnerf.py; the timed path with
half of every scene's rays left out, or with the views averaged one
block late, is not, nor is the reference with either fault in the
program's place; the adapter's items are per-step batches of the
configuration's 4 scenes x 128 rays; the cell's span readers read the
model's spans per step."""

import pytest
import torch

from benchmark.check import judge
from benchmark.control import control_numbers
from benchmark.registry import Registry
from benchmark.run import run_cell
from benchmark.tests.support import adapter, half_batch

CELL = "pixelnerf.train_step"
SEED = 3_000_000_019
CPU = torch.device("cpu")


def _run(reg, fault=None):
    config = reg.config(reg.workload(CELL)["config"])
    with adapter(reg, CELL).tiny(config) as over:
        return run_cell(reg, CELL, SEED, 0.3, True, CPU, over, fault)


def combine_late(prog):
    """The views averaged before block 4 rather than 3 in both levels'
    networks (the latent still added into blocks 0-2)."""
    for mlp in (prog.model.coarse_mlp, prog.model.fine_mlp):
        mlp.combine_layer += 1


def test_a_sound_run_is_correct():
    reg = Registry()
    res = _run(reg)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == set(reg.limits(CELL))


@pytest.mark.parametrize("fault", [half_batch, combine_late])
def test_a_broken_timed_path_is_not_correct(fault):
    res = _run(Registry(), fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["half", "combine"])
def test_the_reference_with_a_fault_is_not_correct(fault):
    reg = Registry()
    config = reg.config(reg.workload(CELL)["config"])
    with adapter(reg, CELL).tiny(config) as over:
        numbers, _ = control_numbers(reg, CELL, SEED, CPU, "f32", fault,
                                     config_over=over)
    assert not judge(numbers, reg.limits(CELL))["correct"], numbers


def test_the_items_are_steps_of_four_scenes_of_128_rays():
    reg = Registry()
    w = reg.workload(CELL)
    config = reg.config(w["config"])
    arch = adapter(reg, CELL)
    mix = dict(reg.traffic(w["traffic"]), img_wh=[40, 30], items_in_pool=2)
    prog = arch.Program(config, SEED, CPU, 1)
    pool = arch.make_items(mix, SEED, CPU, prog.cfg)
    prog.free()
    assert pool["kind"] == "step" and pool["steps_per_item"] == 1
    assert pool["rays_per_item"] == 512 and len(pool["items"]) == 2
    item = pool["items"][0]
    assert item["src_imgs"].shape == (4, 3, 30, 40, 3)
    assert item["src_poses"].shape == (4, 3, 4, 4)
    for k in ("rays_o", "rays_d", "viewdirs", "target"):
        assert item[k].shape == (4, 128, 3), k
    # four distinct scenes
    assert len({item["src_poses"][s, 0, 0, 3].item() for s in range(4)}) \
        == 4


def _item(name, phases, i):
    return {"name": name, "id": i,
            "spans": {p: {"count": 2, "host_ms": ms, "self_host_ms": ms,
                          "device_ms": 2 * ms, "self_device_ms": 2 * ms,
                          "timed": 2} for p, ms in phases}}


def test_the_span_readers_read_the_model_spans_per_step(monkeypatch):
    """gather_device_ms.train and mlp_device_ms.train: the median over the
    window's steps of their spans' device ms; nothing in a view."""
    from neo360_tpu_torch.train import profiling
    reg = Registry()
    listed = {m["name"] for m in reg.metrics(CELL, True)}
    readers = {"gather_device_ms.train": "model.gather",
               "mlp_device_ms.train": "model.mlp",
               "sample_device_ms.train": "model.sample",
               "encoder_device_ms.train": "model.encode"}
    assert set(readers) <= listed
    records = [_item("train.step", [(p, 10.0 * k + i)
                                    for k, p in enumerate(readers.values())],
                     i) for i in range(5)]
    monkeypatch.setattr(profiling, "items", lambda: records)
    ctx = {"kind": "step", "items": 4, "trace": {"busy_s": 1.0},
           "steps_per_item": 1, "window_s": 0.4}
    for k, name in enumerate(readers):
        assert reg.reader(name).read(ctx) == pytest.approx(
            2 * (10.0 * k + 1.5)), name
    view = dict(ctx, kind="view")
    for name in ("gather_device_ms.train", "mlp_device_ms.train"):
        assert reg.reader(name).read(view) is None
