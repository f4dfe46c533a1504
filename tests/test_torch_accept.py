"""scripts/torch_accept_neo360.py's `all` on the CPU at a tiny size
(neo360_fast with grid (8, 8, 4), lift 32, encoder width 64, 8 proposal
and 6 fine samples, float32, K=2 stages of 16 rays, tri-planes shrunk
to 30x40) on a 2-scene 40x30 root: every phase runs through the port's
CLI and writes its JSON line; the eval phases cover both BatchNorm
modes on every test view; the optimize and finetune runs keep the
SpatialEncoder and BatchNorm buffers bit for bit (the script checks)."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from neo360_tpu_torch.nn.triplane import GridEncoder

torch.set_num_threads(1)

TINY = dict(bf16=False, grid_size=(8, 8, 4), encoder_width=64, lift_dim=32,
            num_prop_samples=8, num_fine_samples=6, img_wh=(40, 30),
            ray_batch_size=16, stage_k=2, save_every_steps=4,
            steps_per_call=4, log_every_steps=2)


@pytest.fixture
def script(monkeypatch):
    path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                        "torch_accept_neo360.py")
    spec = importlib.util.spec_from_file_location("torch_accept_neo360",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "OPT_STEPS", 4)
    monkeypatch.setattr(GridEncoder, "plane_hw", (30, 40))
    return mod


def test_accept_all_phases_on_the_cpu(script, tmp_path):
    from neo360_tpu.data.fixtures import make_multi_scene_root
    root = make_multi_scene_root(str(tmp_path / "root"), 2, wh=(40, 30))
    state = str(tmp_path / "state")
    script.main(["all", "--root", root, "--state", state, "--steps", "4,8",
                 "--scenes", "2", "--device", "cpu"], **TINY)
    lines = [json.loads(line) for line in
             open(os.path.join(state, "accept.jsonl"))]
    assert [r["phase"] for r in lines] == ["train", "eval", "train", "eval",
                                           "optimize", "eval", "finetune"]
    assert all(r["card"] == "cpu" for r in lines)
    assert [r["end_step"] for r in lines if r["phase"] == "train"] == [4, 8]
    evals = [r for r in lines if r["phase"] == "eval"]
    assert [(r["exp"], r["ckpt_step"]) for r in evals] == [
        ("accept", 4), ("accept", 8), ("optimize", 4)]
    for r in evals:
        assert r["views"] == 10
        for mode in ("batch", "running"):
            assert np.isfinite(r["modes"][mode]["psnr"])
            assert os.path.exists(os.path.join(
                state, f"results_{r['exp']}_{r['ckpt_step']}_{mode}.json"))
    for r in lines[4], lines[6]:
        assert r["warm_start_step"] == 8 and r["end_step"] == 4
        assert r["frozen_tensors_bit_equal"] > 100
        assert r["trained_tensors_moved"] > 100
        assert len(r["loss"]) == 4 and np.isfinite(r["steady_rays_s"])
    assert lines[4]["rays_per_step"] == 16
    assert lines[6]["rays_per_step"] == 900
    with pytest.raises(ValueError, match="scenes"):
        script.main(["eval", "--root", root, "--state", state, "--scenes",
                     "4", "--device", "cpu"], **TINY)
