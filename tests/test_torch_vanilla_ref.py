"""The port's vanilla NeRF on its plain path (the CPU) against the
benchmark's plain reference (benchmark/reference/vanilla.py), on the
benchmark's seeded weights and views of its `vanilla_orbit` mix, at the
adapter's tiny sizes (benchmark/architectures/vanilla.py TINY: a 2 x 32
trunk with the input again after its second layer, a 16-wide view branch,
8 + 8 samples, 40x30 views in 256-ray tiles), float32, deterministic
samples as a render draws them.

Tolerances: 1e-5 relative plus 1e-6 absolute on each level's colour,
depth, acc and weights, and on a whole view's. Both sides run the same
float32 operations in the same order but two: the inverse-CDF lookup
(`torch.searchsorted` against the reference's dense mask, which pick the
same interval) and the GEMMs' blocking over a tile of 256 rays against
the reference's block of the whole view (measured: equal bits for the
levels of 300 rays at once; at most 6.0e-7 over a view's tiles, on the
depth, 3.0e-7 on the colour). The reference with its
"unmerged" fault (the fine level at its 8 drawn points alone) misses them
by orders of magnitude, as does its colour fault.
"""

import pytest
import torch

from benchmark import weights
from benchmark.architectures import vanilla as adapter
from benchmark.reference import vanilla as ref
from benchmark.registry import Registry

torch.set_num_threads(1)

SEED = 3_000_000_019
RTOL, ATOL = 1e-5, 1e-6
KEYS = ("rgb", "depth", "acc")


@pytest.fixture(scope="module")
def setup():
    """(the port's program at the tiny sizes with the seeded weights, its
    weights, the configuration, two whole 40x30 views)."""
    reg = Registry()
    config = reg.config("vanilla")
    with adapter.tiny(config) as over:
        config = dict(config, **over)
        prog = adapter.Program(config, SEED, torch.device("cpu"), 1)
    mix = dict(reg.traffic("vanilla_orbit"), img_wh=config["img_wh"],
               orbit_views=2)
    w = weights.make(prog.shapes(), SEED, "cpu")
    prog.load(w)
    trained = {k: w[k] for k in prog.trained_names()}
    items = adapter.make_items(mix, SEED, "cpu", prog.cfg)["items"]
    return prog, trained, config, items


def _close(got, want):
    return torch.allclose(got, want, rtol=RTOL, atol=ATOL)


def test_the_items_are_whole_views_of_rays_alone(setup):
    _, _, config, items = setup
    w, h = config["img_wh"]
    assert len(items) == 2
    for item in items:
        assert set(item) == {"rays_o", "rays_d", "viewdirs"}
        assert all(v.shape == (w * h, 3) for v in item.values())


def test_every_level_matches_the_reference(setup):
    prog, trained, config, items = setup
    rays = {k: v[:300] for k, v in items[0].items()}
    with torch.no_grad():
        got = prog.model(rays, False, config["near"], config["far"])
        want = ref.render(trained, ref.Precision(),
                          ref.Arch.from_config(config), rays)
    n0 = config["num_coarse_samples"] + 1
    assert [o["weights"].shape[1] for o in got] == \
        [n0, n0 + config["num_fine_samples"]]
    for level, (a, b) in enumerate(zip(got, want)):
        # a live level: most rays' weights reach past their first sample
        past = b["weights"][:, 1:].sum(-1) > 0.01 * b["acc"]
        assert past.float().mean() > 0.5, level
        for k in KEYS + ("weights", "t_vals"):
            assert _close(a[k], b[k]), (level, k)


def test_a_view_in_tiles_matches_the_reference(setup):
    """A whole view through `make_image_renderer` (1,200 rays, five tiles
    of 256, the last padded), as the benchmark renders it."""
    prog, trained, config, items = setup
    prog.make_renderer(None)
    for item in items:
        got = prog.runner(item)
        want = adapter.reference_render(config, trained, None, item)
        for k in KEYS:
            assert got[k].shape == want[k].shape, k
            assert _close(got[k], want[k]), k


@pytest.mark.parametrize("fault", ref.FAULTS)
def test_the_reference_with_a_fault_misses_the_tolerances(setup, fault):
    prog, trained, config, items = setup
    prog.make_renderer(None)
    got = prog.runner(items[0])
    bad = adapter.reference_render(config, trained, None, items[0],
                                   fault=fault)
    assert not _close(got["rgb"], bad["rgb"])
    assert float((got["rgb"] - bad["rgb"]).abs().max()) > 1e3 * ATOL
    if fault == "unmerged":
        assert float((got["depth"] - bad["depth"]).abs().max()) > 1e3 * ATOL
