"""Everything a cell needs, found by name: BENCHMARK.json at the root of
the checkout names the cells, and each cell's parts are files of their
own under this folder:

- `configs/<config>.json`: the configuration as run (the `file` key of
  its BENCHMARK.json entry);
- `traffic/<traffic>.json`: the mix's parameters, read by scenes.py;
- `metrics/<metric>.py`: a per-layer metric's reader, `read(ctx) ->
  number or None`;
- `rooflines/<family>.py`: an operation family's `KERNELS` (patterns of
  the kernel names whose device time it claims) and `least_bytes(work)`;
- `limits/<cell>.json`: the limit of each number that decides `correct`.

A later cell, configuration, metric or family is a new file and a new
entry, and no existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Registry:
    def __init__(self, root: Path = ROOT, here: Path = HERE):
        self.root, self.here = Path(root), Path(here)
        self.bench = _json(self.root / "BENCHMARK.json")

    def workload(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return _json(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return _json(self.here / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> Dict[str, float]:
        return _json(self.here / "limits" / f"{cell}.json")

    def metrics(self, cell: str, trace: bool) -> List[Dict]:
        """The cell's metrics for a run: end-to-end (trace 0) or per-layer
        (trace 1), in BENCHMARK.json's order."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[key]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> ModuleType:
        return _module(self.here / "metrics" / f"{metric}.py")

    def families(self) -> Dict[str, ModuleType]:
        return {p.stem: _module(p) for p in
                sorted((self.here / "rooflines").glob("*.py"))}
