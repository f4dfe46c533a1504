"""The comparison that decides `correct`, on the CPU at a tiny size: every
cell's whole run, and that of the production preset's stage cell
(support.with_production), (run.run_cell with the port's plain versions)
comes out correct, with the reference agreeing with the port's plain
path; the same run with its timed path broken comes out not correct,
once for each fault the cell can have. Every cell runs at the sizes its
configuration's adapter gives (`tiny`), so a later architecture's cells
are covered with no edit here. The control (the reference in the
program's place one precision down: TF32, which exists only on the card,
or fp8) is held at the cells' own sizes, on the card (`cuda` tests)."""

import pytest
import torch

from benchmark import scenes
from benchmark.check import judge
from benchmark.control import LOWER, control_numbers
from benchmark.registry import Registry
from benchmark.run import run_cell
from benchmark.tests.support import (STAGE_CELL, adapter, altered,
                                     half_batch, unchanged, with_production)

BENCH = Registry()
ROLE = {w["name"]: scenes.ROLE[BENCH.traffic(w["traffic"])["kind"]]
        for w in BENCH.bench["workloads"]}
ROLE[STAGE_CELL] = "stage"
CELLS = [w["name"] for w in BENCH.bench["workloads"]]
TRAIN = [c for c, r in ROLE.items() if r != "view"]
RENDER = [c for c, r in ROLE.items() if r == "view"]
SEED = 3_000_000_019      # more than 31 bits: any seed a run is given


@pytest.fixture
def reg(tmp_path):
    """The cells of BENCHMARK.json and the production preset's stage
    cell."""
    return with_production(tmp_path)


def run(reg, cell, fault=None, seed=SEED):
    config = reg.config(reg.workload(cell)["config"])
    with adapter(reg, cell).tiny(config) as over:
        return run_cell(reg, cell, seed, 0.5, True, torch.device("cpu"),
                        over, fault)


@pytest.mark.parametrize("cell", CELLS + [STAGE_CELL])
def test_sound_run_is_correct_and_agrees_with_the_plain_path(cell, reg):
    res = run(reg, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    # float32 plain path against the float32 reference: rounding only
    for name, c in res["checks"].items():
        assert c["value"] < 5e-3, (name, c)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in TRAIN
                                        for f in (unchanged, half_batch)]
                         + [(c, altered) for c in RENDER])
def test_broken_timed_path_is_not_correct(cell, fault, reg):
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
