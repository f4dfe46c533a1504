"""Everything a cell needs, found by name: BENCHMARK.json at the root of
the checkout names the cells, and each cell's parts are files of their
own under this folder:

- `configs/<config>.json`: the configuration as run (the `file` key of
  its BENCHMARK.json entry);
- `architectures/<architecture>.py`: the adapter of the configuration's
  architecture, named by the configuration's `architecture` key, else by
  its `exp_type` (the interface is below);
- `traffic/<traffic>.json`: the mix's parameters, read by scenes.py;
- `metrics/<metric>.py`: a per-layer metric's reader, `read(ctx) ->
  number or None`;
- `rooflines/<family>.py`: an operation family's `KERNELS` (patterns of
  the kernel names whose device time it claims) and `least_bytes(work)`,
  of the work of the architectures that name it;
- `limits/<cell>.json`: the limit of each number that decides `correct`.

An adapter (architectures/neo360.py is one) gives the shared harness
(run.py, control.py, check.py, scenes.py, readers.py) all it knows of an
architecture:
- `Program(config, seed, device, generator_seed)`: the system under test,
  with `cfg`, `shapes()`, `trained_names()`, `load(weights)`,
  `trainer_kind()`, `make_trainer()`, `make_renderer(setup)`, `runner`
  (one item a call), `recording` / `recorded` (the losses of the items
  run while recording), `moments()`, `params()` and `free()`;
- `kernel_library()`: build or load the program's kernels (on the card);
- `make_items(mix, seed, device, cfg)`: scenes.make_items' pool at the
  program's sizes;
- `reference_train(config, params, trainer, items, gen_seed, device,
  kind="f32", fault=None)` and `reference_render(config, params, setup,
  rays, kind="f32", fault=None)`: the plain reference, in the control's
  precision `kind` or with a fault of `FAULTS` planted;
- `work(config, mix, cfg)` and `item_flops(work)`: one item's work, which
  the roofline families named in `FAMILIES` count, and its model FLOPs;
- `FAMILIES`, `FAULTS`, and `tiny(config)`: a context manager that
  yields the configuration keys the CPU tests replace (`tiny_sizes`).

The rules:
- only `architectures/*.py` import the program (neo360_tpu_torch), and
  only inside the functions that drive it; spans.py reads the recorder
  the program has loaded, by its module name, and imports nothing of it;
- a reference (reference/) imports nothing of the program: no kernel, no
  weights, nothing it made; and nothing here imports JAX, jaxlib, flax or
  the JAX package neo360_tpu;
- a later cell, configuration, metric or family is a new file and a new
  entry, and no existing file changes. A new architecture brings, as new
  files, its adapter (architectures/<name>.py), its plain reference
  (under reference/), its configuration (configs/), its traffic
  (traffic/, a data file that scenes.py's kinds read), its cells' limits
  (limits/), its roofline families (rooflines/) and any metric readers
  of its own (metrics/); in BENCHMARK.json, its configuration's and its
  cells' entries, and the new cells' names on the `workloads` of the
  existing metrics they report.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, prefix: str = "") -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + prefix + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # a dataclass looks its module up
    spec.loader.exec_module(mod)
    return mod


class Registry:
    def __init__(self, root: Path = ROOT, here: Path = HERE):
        self.root, self.here = Path(root), Path(here)
        self.bench = _json(self.root / "BENCHMARK.json")
        self._adapters: Dict[str, ModuleType] = {}

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

    def architecture(self, config: Dict) -> ModuleType:
        """The adapter of the configuration's architecture, loaded once."""
        name = config.get("architecture", config["exp_type"])
        if name not in self._adapters:
            self._adapters[name] = _module(
                self.here / "architectures" / f"{name}.py", "arch_")
        return self._adapters[name]

    def families(self, names) -> Dict[str, ModuleType]:
        """The roofline families `names` (an adapter's FAMILIES)."""
        return {n: _module(self.here / "rooflines" / f"{n}.py")
                for n in names}
