"""The port's throughput benchmark (`python -m neo360_tpu_torch.bench`) on
the CPU at a tiny size: grid (8, 8, 4), encoder width 64, lift 32, 8 + 6
samples, 40x30 fixture scenes, 16 rays a step, tri-planes shrunk to 30x40
(`GridEncoder.plane_hw`), float32 (the CPU's bf16 convolutions are not
deterministic at some shapes in torch 2.13, and can give NaN).

- `example_inputs` equals the JAX package's `__graft_entry__.
  _example_inputs` bit for bit (exact equality), for two seeds and two
  sizes.
- Each mode (proposal and reference training, render) and `--profile`
  prints one JSON line last, whose figures are finite and positive.
- `--device cuda` without a card raises; the module imports no JAX.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from neo360_tpu_torch import bench
from neo360_tpu_torch.nn.triplane import GridEncoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--wh", "40", "30", "--grid", "8,8,4", "--encw",
        "64", "--lift", "32", "--prop", "8", "--coarse", "8", "--fine", "6",
        "--rays", "16", "--chunk", "200", "--repeats", "2", "--steps", "2",
        "--no-bf16"]


@pytest.mark.parametrize("n_rays,hw", [(64, (48, 64)), (500, (240, 320))])
@pytest.mark.parametrize("seed", [0, 1])
def test_example_inputs_equal_the_jax_package(n_rays, hw, seed):
    from __graft_entry__ import _example_inputs
    ref = _example_inputs(n_rays=n_rays, hw=hw, seed=seed)
    ours = bench.example_inputs(n_rays=n_rays, hw=hw, seed=seed)
    assert set(ours) == set(ref)
    for k, v in ours.items():
        r = np.asarray(ref[k])
        assert v.dtype == r.dtype == np.float32 and v.shape == r.shape, k
        np.testing.assert_array_equal(v, r, err_msg=k)


def _run(argv, capsys, monkeypatch):
    monkeypatch.setattr(GridEncoder, "plane_hw", (30, 40))
    assert bench.main(TINY + argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    result = json.loads(lines[-1])
    for k in ("value", "median_s", "min_s", "max_s", "first_s"):
        assert math.isfinite(result[k]) and result[k] > 0, (k, result)
    assert result["n"] == 2 and result["unit"] == "rays/s"
    assert result["min_s"] <= result["median_s"] <= result["max_s"]
    assert result["device"] == "cpu" and result["card"] is None
    return result, lines[:-1]


@pytest.mark.parametrize("argv,metric,rays", [
    ([], "train", 2 * 16),
    (["--mode", "reference"], "train", 2 * 16),
    (["--mode", "reference", "--stage", "2"], "train", 2 * 16),
    (["--phase", "render"], "render", 40 * 30),
    (["--synthetic"], "train", 2 * 16),
    (["--synthetic", "--phase", "render", "--mode", "reference"], "render",
     40 * 30),
])
def test_bench_modes_on_the_cpu(argv, metric, rays, capsys, monkeypatch):
    """Proposal training (the stage trainer, K=2 here, S=2), reference
    training (the per-step trainer, 2 steps a window, and the stage
    trainer when asked), render, on fixture scenes or `example_inputs`:
    rays/s = rays of a window / the median window."""
    if "--stage" not in argv:
        argv = argv + ["--stage", "2" if "reference" not in argv else "0"]
    result, _ = _run(argv, capsys, monkeypatch)
    assert result["metric"] == f"neo360_{metric}_rays_per_sec_on_cpu"
    assert result["value"] == pytest.approx(rays / result["median_s"])
    knobs = result["knobs"]
    assert (knobs["grid"], knobs["encw"], knobs["lift"], knobs["bf16"]) == (
        [8, 8, 4], 64, 32, False)
    if metric == "render":
        assert result["encode_s"] > 0 and result["encode_first_s"] > 0


def test_bench_narrow_knobs(capsys, monkeypatch):
    """The width knobs reach the model: plane_dim 32, local_proj_dim 32,
    pillar width 8, one DepthPillarEncoder hidden layer, the bf16
    cotangent accumulator."""
    result, _ = _run(["--stage", "2", "--planed", "32", "--locald", "32",
                      "--pillw", "8", "--depthl", "1", "--cot", "bf16"],
                     capsys, monkeypatch)
    knobs = result["knobs"]
    assert (knobs["planed"], knobs["locald"], knobs["pillw"],
            knobs["depthl"], knobs["cot"]) == (32, 32, 8, 1, "bf16")


def test_bench_profile(tmp_path, capsys, monkeypatch):
    """`--profile DIR` traces one more window into DIR and prints its
    per-op table before the result (host ops on the CPU, which records
    no device time)."""
    result, lines = _run(["--stage", "2", "--profile", str(tmp_path),
                          "--top", "5"], capsys, monkeypatch)
    table = [line for line in lines if line.startswith("[profile]")]
    assert len(table) >= 6 and "no device time" in table[0]
    assert result["busy_share"] is None
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path))


def test_bench_needs_the_card_it_names(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--repeats", "1"])


def test_bench_imports_no_jax():
    code = ("import sys, neo360_tpu_torch.bench; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'neo360_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
