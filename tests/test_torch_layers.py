"""The port's layers depend one way: the math, kernel, network, model and
data modules (`core`, `ops`, `nn`, `models`, `data`) import nothing of
the trainer, the data-parallel layer, the CLI or the bench; and the span
recorder the models time themselves with (`core/spans.py`) is the one
the benchmark reads, through `train/profiling.py`."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "neo360_tpu_torch"
LOWER = ("core", "ops", "nn", "models", "data")
UPPER = tuple(f"{PACKAGE}.{m}" for m in ("train", "parallel", "cli",
                                         "bench"))


def _imports(path: Path):
    """Every module `path` imports, at module level or inside a function,
    relative imports resolved; `from a import b` gives a and a.b."""
    package = path.relative_to(ROOT).with_suffix("").parts[:-1]
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parent = package[:len(package) - node.level + 1]
                base = ".".join(parent + ((base,) if base else ()))
            yield base
            yield from (f"{base}.{a.name}" for a in node.names)


def test_lower_layers_import_no_upper_layer():
    files = [f for layer in LOWER
             for f in sorted((ROOT / PACKAGE / layer).glob("*.py"))]
    assert len(files) > len(LOWER)
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f)
           if any(name == u or name.startswith(u + ".") for u in UPPER)]
    assert not bad


def test_the_benchmark_reads_the_models_recorder():
    """After `train.loop` is imported (both architectures' adapters import
    it), the module the benchmark reads the recorder from is loaded and
    its recorder names are `core/spans.py`'s objects."""
    code = (
        "import sys\n"
        "import neo360_tpu_torch.train.loop\n"
        "from benchmark.spans import RECORDER\n"
        "from neo360_tpu_torch.core import spans\n"
        "read = sys.modules[RECORDER]\n"
        "assert RECORDER == 'neo360_tpu_torch.train.profiling'\n"
        "for name in ('item', 'span', 'items', 'enable', 'clear',\n"
        "             'MAX_ITEMS'):\n"
        "    assert getattr(read, name) is getattr(spans, name), name\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
