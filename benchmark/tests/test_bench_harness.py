"""The harness's last line and its refusals: the result's keys and their
order; no card, no result; JAX or the JAX package loaded, no result; the
harness, every architecture's adapter and the references load neither,
and nothing but the adapters' programs loads the port (checked in a fresh
interpreter, and in the sources)."""

import ast
import json
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.registry import HERE, ROOT, Registry
from benchmark.tests.support import adapter


def test_result_line_keeps_the_contract():
    reg = Registry()
    cell = reg.bench["workloads"][-1]["name"]
    config = reg.config(reg.workload(cell)["config"])
    for trace in (False, True):
        with adapter(reg, cell).tiny(config) as over:
            res = run.run_cell(reg, cell, 7, 0.3, trace,
                               torch.device("cpu"), over)
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
from benchmark.registry import Registry
reg = Registry()
for c in reg.bench["configs"]:
    arch = reg.architecture(reg.config(c["name"]))
    reg.families(arch.FAMILIES)
for m in reg.bench["per_layer"]:
    reg.reader(m["name"])
tops = {{m.split(".")[0] for m in sys.modules}}
print(json.dumps(sorted(tops & {{"jax", "jaxlib", "flax", "neo360_tpu",
                                 "neo360_tpu_torch"}})))
"""
HARNESS = ("benchmark.run, benchmark.control, benchmark.check, "
           "benchmark.scenes, benchmark.weights, benchmark.spans, "
           "benchmark.readers, benchmark.trace, benchmark.reference.model, "
           "benchmark.reference.train")


@pytest.mark.parametrize("mods,allowed", [
    (HARNESS + ", neo360_tpu_torch.cli", ["neo360_tpu_torch"]),
    (HARNESS, []),
])
def test_imports_in_a_fresh_interpreter(mods, allowed):
    """The harness with every configuration's adapter, roofline family
    and metric reader loaded imports nothing of the program, and the
    program (the port's CLI) loads no JAX."""
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", IMPORTS.format(mods=mods)],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == allowed


def _imported(path):
    """The top-level names a source file imports."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_only_the_adapters_import_the_program():
    """No source of the benchmark imports JAX or the JAX package; outside
    architectures/ and tests/, none imports the program either."""
    for path in sorted(HERE.rglob("*.py")):
        rel = path.relative_to(HERE).parts
        found = _imported(path)
        assert not found & {"jax", "jaxlib", "flax", "neo360_tpu"}, path
        if rel[0] not in ("architectures", "tests"):
            assert "neo360_tpu_torch" not in found, path
