"""BENCHMARK.json and the files it names: every cell, configuration,
architecture adapter, traffic mix, per-layer metric and limit resolves to
its file by name; every configuration's adapter offers the interface and
counts the work of each of its cells at the sizes it gives (`tiny`); a
file dropped into a copy of the folder is found with no existing file
edited; the entries keep the contract's shape."""

import json
import re
import shutil

import pytest
import torch

from benchmark.registry import ROOT, Registry
from benchmark.tests.support import adapter

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"] == ["python3", "-m", "benchmark.run"]
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    reg = Registry()
    w = reg.workload(cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and w["chips"] == 1
    assert 1 <= len(w["why"]) <= 200
    cfg = reg.config(w["config"])
    assert cfg["name"] == w["config"]
    assert reg.traffic(w["traffic"])["name"] == w["traffic"]
    limits = reg.limits(cell)
    assert limits and all(v > 0 for v in limits.values())
    for trace in (False, True):
        metrics = reg.metrics(cell, trace)
        assert metrics, (cell, trace)
        for m in metrics:
            if trace:
                assert hasattr(reg.reader(m["name"]), "read")
    names = [m["name"] for m in reg.metrics(cell, False)]
    assert "setup_s" in names and len(names) >= 2


INTERFACE = ("Program", "kernel_library", "make_items", "reference_train",
             "reference_render", "work", "item_flops", "FAMILIES", "FAULTS",
             "tiny", "tiny_sizes")


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_every_configuration_resolves_to_an_adapter(config):
    reg = Registry()
    cfg = reg.config(config)
    arch = reg.architecture(cfg)
    name = cfg.get("architecture", cfg["exp_type"])
    assert (ROOT / "benchmark" / "architectures" / f"{name}.py").exists()
    assert reg.architecture(dict(cfg)) is arch      # loaded once
    for attr in INTERFACE:
        assert hasattr(arch, attr), (config, attr)
    assert arch.FAMILIES and len(set(arch.FAMILIES)) == len(arch.FAMILIES)
    for fam in reg.families(arch.FAMILIES).values():
        assert fam.KERNELS and callable(fam.least_bytes)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_counts_its_work_at_its_adapters_tiny_sizes(cell):
    """The program built at the adapter's tiny sizes; the work of one item
    of the cell's mix: its FLOPs and each family's least bytes."""
    reg = Registry()
    arch = adapter(reg, cell)
    w = reg.workload(cell)
    config = reg.config(w["config"])
    mix = reg.traffic(w["traffic"])
    with arch.tiny(config) as over:
        config = dict(config, **over)
        mix["img_wh"] = over.get("img_wh", mix["img_wh"])
        prog = arch.Program(config, 1, torch.device("cpu"), 1)
        wk = arch.work(config, mix, prog.cfg)
        prog.free()
    assert arch.item_flops(wk) > 0
    for fam in reg.families(arch.FAMILIES).values():
        assert fam.least_bytes(wk) >= 0


def test_configs_and_metrics_keep_the_contract():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
        assert (ROOT / c["file"]).exists()
        assert not any(k.endswith(("_dim", "_rank", "width"))
                       for k in c["reduced"])
    seen = set()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in seen
        seen.add(m["name"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def test_a_new_file_is_found_without_editing_any(tmp_path):
    """A new mix, metric, roofline family and cell in a copy of the
    folder: found by name, and every existing file byte for byte as it
    was."""
    here = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    bench = dict(BENCH)
    (here / "traffic" / "train_step_long.json").write_text(json.dumps(
        dict(json.loads((here / "traffic" / "train_step.json")
                        .read_text()), name="train_step_long",
             items_in_pool=80)))
    (here / "metrics" / "encode_ms.train.py").write_text(
        "def read(ctx):\n    return 1.5\n")
    (here / "rooflines" / "new_family.py").write_text(
        "KERNELS = ('new_kernel',)\n\n\ndef least_bytes(w):\n"
        "    return 0\n")
    (here / "limits" / "neo360.train_step_long.json").write_text(
        json.dumps({"loss_gap": 0.1}))
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "neo360.train_step_long", "config": "neo360",
         "traffic": "train_step_long", "chips": 1, "why": "longer pool"}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "encode_ms.train", "unit": "ms", "better": "lower",
         "source": "device_trace", "layer": "model step",
         "moves": "train_rays_per_s",
         "workloads": ["neo360.train_step_long"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    reg = Registry(root=tmp_path, here=here)
    cell = "neo360.train_step_long"
    assert reg.traffic(reg.workload(cell)["traffic"])["items_in_pool"] == 80
    assert [m["name"] for m in reg.metrics(cell, True)][-1] == \
        "encode_ms.train"
    assert reg.reader("encode_ms.train").read({}) == 1.5
    assert list(reg.families(["new_family"])) == ["new_family"]
    assert reg.limits(cell) == {"loss_gap": 0.1}
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_every_file_of_the_folder_is_named_from_name_characters():
    for p in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel) and len(rel) <= 200, rel
