"""The comparison that decides `correct`, on the CPU at a tiny size: every
cell's whole run, and that of the production preset's stage cell
(support.with_production), (run.run_cell with the port's plain versions) comes out
correct, with the reference agreeing with the port's plain path; the same
run with its timed path broken comes out not correct, once for each
fault the cell can have. The control (the reference in the program's
place one precision down: TF32, which exists only on the card, or fp8)
is held at the cells' own sizes, on the card (`cuda` tests)."""

import pytest
import torch

from benchmark import scenes
from benchmark.control import LOWER, control_numbers
from benchmark.check import judge
from benchmark.registry import Registry
from benchmark.run import run_cell
from benchmark.tests.support import STAGE_CELL, tiny_over, with_production

CELLS = [w["name"] for w in Registry().bench["workloads"]]
TRAIN = [c for c in CELLS if "train" in c] + [STAGE_CELL]
RENDER = [c for c in CELLS if "render" in c]
SEED = 3_000_000_019      # more than 31 bits: any seed a run is given


@pytest.fixture
def tiny_planes(monkeypatch):
    from neo360_tpu_torch.nn.triplane import GridEncoder
    monkeypatch.setattr(GridEncoder, "plane_hw", (30, 40))


@pytest.fixture
def reg(tmp_path):
    """The cells of BENCHMARK.json and the production preset's stage
    cell."""
    return with_production(tmp_path)


def run(reg, cell, fault=None, seed=SEED):
    return run_cell(reg, cell, seed, 0.5, True, torch.device("cpu"),
                    tiny_over(cell), fault)


@pytest.mark.parametrize("cell", CELLS + [STAGE_CELL])
def test_sound_run_is_correct_and_agrees_with_the_plain_path(cell, reg,
                                                             tiny_planes):
    res = run(reg, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    # float32 plain path against the float32 reference: rounding only
    for name, c in res["checks"].items():
        assert c["value"] < 5e-3, (name, c)


def unchanged(prog):
    """A step that returns its state unchanged."""
    st = prog.state
    for opt in ([st.opt] if hasattr(st, "opt") else [st.enc_opt,
                                                      st.ray_opt]):
        opt.step = lambda grads: None


def half_batch(prog):
    """Half of every ray batch left out; the loss is the mean over the
    rest."""
    inner = prog.runner
    keys = scenes.RAY_KEYS + ("target",)

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


@pytest.mark.parametrize("cell,fault", [(c, f) for c in TRAIN
                                        for f in (unchanged, half_batch)]
                         + [(c, altered) for c in RENDER])
def test_broken_timed_path_is_not_correct(cell, fault, reg, tiny_planes):
    res = run(reg, cell, fault)
    assert not res["correct"], res["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_the_cells_size_is_not_correct(card, cell):
    """The control of a float32 cell (TF32) or a bfloat16 one (fp8) at the
    cell's own size, on the card, one seed."""
    reg = Registry()
    config = reg.config(reg.workload(cell)["config"])
    numbers, _ = control_numbers(reg, cell, SEED, card,
                                 LOWER[config["precision"]])
    assert not judge(numbers, reg.limits(cell))["correct"], numbers
