"""scripts/torch_accept_baselines.py's six phases on the CPU at a tiny
size (40x30 scenes written by the script, 8 + 8 samples for vanilla and
PixelNeRF, 8 + 8 + 4 and MLP widths 32 for MipNeRF-360, 64-ray vanilla and
MipNeRF-360 and 16-ray PixelNeRF steps, float32): every phase runs
through the port's CLI and writes its JSON line, a second train call
resumes, and the eval lines hold every test view in each BatchNorm
mode."""

import functools
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TINY = dict(img_wh=(40, 30), steps_per_call=2, save_every_steps=2,
            chunk=600)


@pytest.fixture
def script():
    path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                        "torch_accept_baselines.py")
    spec = importlib.util.spec_from_file_location("torch_accept_baselines",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("model,extra,views,modes", [
    ("vanilla", dict(batch_size=64, num_coarse_samples=8,
                     num_fine_samples=8), 5, ["batch"]),
    ("pixelnerf", dict(ray_batch_size=16, bf16=False, num_coarse_samples=8,
                       num_fine_samples=8), 9, ["batch", "running"]),
    ("mip", dict(batch_size=64, num_prop_samples=8, num_fine_samples=4), 5,
     ["batch"])])
def test_accept_phases_on_the_cpu(script, tmp_path, monkeypatch, model,
                                  extra, views, modes):
    from neo360_tpu_torch.models import mipnerf360
    monkeypatch.setattr(mipnerf360, "MipNeRF360", functools.partial(
        mipnerf360.MipNeRF360, nerf_netwidth=32, prop_netdepth=2,
        prop_netwidth=32))
    state = str(tmp_path / "state")
    run = lambda phase, *a: script.main(
        [f"{model}_{phase}", "--state", state, "--device", "cpu", *a],
        wh=(40, 30), **TINY, **extra)
    first = run("train", "--steps", "2")
    second = run("train", "--steps", "4")
    assert (first["end_step"], second["end_step"]) == (2, 4)
    assert second["newest_ckpt"] == 4 and second["card"] == "cpu"
    assert set(second["val_psnr"]) == {2, 4}
    line = run("eval")
    name = script.MODELS[model]
    assert line["ckpt_step"] == 4 and line["model"] == name
    assert sorted(line["modes"]) == sorted(modes)
    for mode in modes:
        r = line["modes"][mode]
        assert r["views"] == views and np.isfinite(r["psnr"])
        assert r["passes"] is False     # 4 steps do not reach the bar
        assert os.path.exists(os.path.join(state,
                                           f"results_{name}_{mode}.json"))
    lines = [json.loads(x) for x in open(os.path.join(state,
                                                      "accept.jsonl"))]
    assert [x["phase"] for x in lines] == ["train", "train", "eval"]
