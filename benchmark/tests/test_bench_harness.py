"""The harness's last line and its refusals: the result's keys and their
order; no card, no result; JAX or the JAX package loaded, no result; the
harness and the reference load neither, and the reference loads nothing
of the program (checked in a fresh interpreter)."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.registry import ROOT, Registry
from benchmark.tests.support import tiny_over


def test_result_line_keeps_the_contract(monkeypatch):
    from neo360_tpu_torch.nn.triplane import GridEncoder
    monkeypatch.setattr(GridEncoder, "plane_hw", (30, 40))
    reg = Registry()
    cell = reg.bench["workloads"][-1]["name"]
    for trace in (False, True):
        res = run.run_cell(reg, cell, 7, 0.3, trace, torch.device("cpu"),
                           tiny_over(cell))
        del res["numbers"]      # main logs them and leaves them out
        keys = list(res)
        assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                            "device"]
        assert keys[-1] == "checks"
        assert ("breakdown" in res) == trace
        assert set(keys) <= {"correct", "attempted", "failed", "metrics",
                             "device", "breakdown", "checks"}
        want = {m["name"] for m in reg.metrics(cell, trace)}
        assert set(res["metrics"]) <= want
        for m in res["metrics"].values():
            assert set(m) == {"value", "unit"}
        if not trace:
            assert set(res["metrics"]) == want
        else:
            assert {"busy_s", "window_s"} <= set(res["device"])
            for part in ("device_ops", "idle_gaps"):
                assert len(res["breakdown"][part]) <= 10
        for c in res["checks"].values():
            assert set(c) == {"value", "limit"}
        json.dumps(res)


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "neo360.train_step", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "neo360_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "neo360_tpu.models", sys)
    assert run.forbidden_modules() == ["neo360_tpu"]


IMPORTS = """
import json, sys
import {mods}
tops = {{m.split(".")[0] for m in sys.modules}}
print(json.dumps(sorted(tops & {{"jax", "jaxlib", "flax", "neo360_tpu",
                                 "neo360_tpu_torch"}})))
"""


@pytest.mark.parametrize("mods,allowed", [
    ("benchmark.run, benchmark.reference, benchmark.program, "
     "benchmark.control, neo360_tpu_torch.cli", ["neo360_tpu_torch"]),
    ("benchmark.reference.model, benchmark.reference.train, "
     "benchmark.check, benchmark.scenes, benchmark.weights", []),
])
def test_imports_in_a_fresh_interpreter(mods, allowed):
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", IMPORTS.format(mods=mods)],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == allowed
