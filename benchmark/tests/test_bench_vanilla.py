"""The `vanilla.render_view` cell on the CPU (run.run_cell with the port's
plain versions, at its adapter's tiny sizes): the registry finds the cell
and its files; a sound run is correct against
benchmark/reference/vanilla.py; the timed path with every answer altered,
or with the fine level at its drawn points alone, is not, nor is the
reference with either of its faults in the program's place; at the
published widths the MLP is 593,408 multiply-adds a sample and a view
23.5 TFLOP, and kernel D's family counts the view's bytes."""

import pytest
import torch

from benchmark.check import judge
from benchmark.control import control_numbers
from benchmark.registry import HERE, Registry
from benchmark.run import run_cell
from benchmark.tests.support import adapter, altered

CELL = "vanilla.render_view"
SEED = 3_000_000_019
CPU = torch.device("cpu")


def _run(reg, fault=None):
    config = reg.config(reg.workload(CELL)["config"])
    with adapter(reg, CELL).tiny(config) as over:
        return run_cell(reg, CELL, SEED, 0.3, True, CPU, over, fault)


def unmerged(prog):
    """The fine level's points drawn but not merged with the coarse
    level's, in every view the program renders."""
    from neo360_tpu_torch.core import sampling
    from neo360_tpu_torch.models import vanilla

    class Unmerged:
        def __getattr__(self, name):
            return getattr(sampling, name)

        @staticmethod
        def sample_pdf(bins, weights, origins, directions, t_vals, n,
                       randomized=False, u=None, generator=None):
            t = sampling.sorted_piecewise_constant_pdf(
                bins, weights, n, randomized, u, generator)
            t = torch.sort(t, dim=-1).values
            return t, sampling.cast_rays(t, origins, directions)

    saved = vanilla.sampling
    inner = prog.runner

    def run(rays):
        vanilla.sampling = Unmerged()
        try:
            return inner(rays)
        finally:
            vanilla.sampling = saved
    prog.runner = run


def test_the_registry_finds_the_cell_and_its_files():
    reg = Registry()
    w = reg.workload(CELL)
    assert (w["config"], w["traffic"], w["chips"]) == \
        ("vanilla", "vanilla_orbit", 1)
    config = reg.config("vanilla")
    assert config["architecture"] == config["exp_type"] == "vanilla"
    assert reg.traffic("vanilla_orbit")["kind"] == "image"
    assert set(reg.limits(CELL)) == {"rgb_p99_gap", "depth_p99_gap",
                                     "rgb_gap", "depth_gap"}
    arch = reg.architecture(config)
    assert arch.FAMILIES == ("vanilla_composite",)
    assert {"rgb", "unmerged"} <= set(arch.FAULTS)
    assert (HERE / "reference" / "vanilla.py").exists()
    e2e = {m["name"] for m in reg.metrics(CELL, False)}
    assert e2e == {"setup_s", "render_rays_per_s"}
    per_layer = {m["name"] for m in reg.metrics(CELL, True)}
    assert {"sample_device_ms.render", "mlp_device_ms.render",
            "tile_replay_share.render", "mfu.render",
            "kernel_roofline_share.render"} <= per_layer
    assert not {"gather_device_ms.render",
                "mlp_inputs_in_place_share.render"} & per_layer


def test_a_sound_run_is_correct():
    reg = Registry()
    res = _run(reg)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == set(reg.limits(CELL))


@pytest.mark.parametrize("fault", [altered, unmerged])
def test_a_broken_timed_path_is_not_correct(fault):
    res = _run(Registry(), fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["rgb", "unmerged"])
def test_the_reference_with_a_fault_is_not_correct(fault):
    reg = Registry()
    config = reg.config(reg.workload(CELL)["config"])
    with adapter(reg, CELL).tiny(config) as over:
        numbers, _ = control_numbers(reg, CELL, SEED, CPU, "f32", fault,
                                     config_over=over)
    assert not judge(numbers, reg.limits(CELL))["correct"], numbers


def _published_work():
    reg = Registry()
    w = reg.workload(CELL)
    config = reg.config(w["config"])
    arch = adapter(reg, CELL)
    return arch, arch.work(config, reg.traffic(w["traffic"]), None)


def test_item_flops_at_the_published_widths():
    """63 -> 256, 4 x 256^2, 319 -> 256, 2 x 256^2, the density and the
    bottleneck, 283 -> 128, 128 -> 3: 593,408 multiply-adds a sample;
    76,800 rays x (65 + 193) samples a view."""
    arch, wk = _published_work()
    assert (wk.rays, wk.samples) == (76_800, (65, 193))
    macs = (63 * 256 + 4 * 256 ** 2 + 319 * 256 + 2 * 256 ** 2 + 256
            + 256 ** 2 + 283 * 128 + 128 * 3)
    assert arch.mlp_macs(wk) == macs == 593_408
    assert arch.item_flops(wk) == 2 * 593_408 * 76_800 * 258
    assert arch.item_flops(wk) == pytest.approx(23.5e12, rel=2e-3)


def test_the_composite_family_counts_the_views_bytes():
    """Kernel D per level: each sample's rgb, density and t read and its
    weight written (6 floats), the ray's direction read and its rgb, acc
    and depth written (8)."""
    arch, wk = _published_work()
    fam = Registry().families(arch.FAMILIES)["vanilla_composite"]
    per_ray = (6 * 65 + 8) + (6 * 193 + 8)
    assert fam.least_bytes(wk) == 76_800 * per_ray * 4
