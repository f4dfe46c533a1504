"""The port's CLI for the vanilla NeRF and PixelNeRF and the vis_only
eval mode, on the CPU at a tiny size (40x30 fixture scenes, 8 + 8
samples, the presets' widths; neo360 / neo360_fast cut as in
tests/test_torch_cli_neo360.py), mirroring tests/test_cli.py's
test_vanilla_train_then_eval and test_render_trajectory_*: train,
checkpoint, resume, full_eval and vis_only through the entry points a
user calls. The CLI has no size flags, so `parse_args` is wrapped to
apply the tiny sizes.
"""

import json
import os

import numpy as np
import pytest
import torch

from neo360_tpu_torch import cli
from neo360_tpu_torch.config import preset
from neo360_tpu_torch.data.fixtures import make_micro_scene, \
    make_multi_scene_root
from neo360_tpu_torch.data.nerds360 import NeRDS360
from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE
from neo360_tpu_torch.nn.triplane import GridEncoder

torch.set_num_threads(1)

WH = (40, 30)
TINY = {"vanilla": dict(num_coarse_samples=8, num_fine_samples=8,
                        steps_per_call=5),
        "pixelnerf": dict(num_coarse_samples=8, num_fine_samples=8),
        "neo360": dict(grid_size=(8, 8, 8), encoder_width=64,
                       num_coarse_samples=8, num_fine_samples=6),
        "neo360_fast": dict(bf16=False, grid_size=(8, 8, 4),
                            encoder_width=64, lift_dim=32,
                            num_prop_samples=8, num_fine_samples=6)}


@pytest.fixture
def tiny_cli(monkeypatch):
    parse = cli.parse_args

    def tiny(argv):
        cfg = parse(argv)
        return cfg.replace(**TINY[cfg.exp_type])

    monkeypatch.setattr(cli, "parse_args", tiny)
    monkeypatch.setattr(GridEncoder, "plane_hw", (30, 40))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """One vanilla scene written by the port's own fixture writer."""
    return make_micro_scene(str(tmp_path_factory.mktemp("scene")), n_val=2,
                            wh=WH)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return make_multi_scene_root(str(tmp_path_factory.mktemp("scenes")), 2,
                                 n_val=1, wh=WH)


def _argv(exp_type, root, ckpt_dir, *extra):
    return ["--exp_type", exp_type, "--root_dir", root, "--img_wh", "40",
            "30", "--ckpt_dir", str(ckpt_dir), "--device", "cpu",
            "--chunk", "600", *extra]


def _checks_eval(exp_dir, summary, views, vis=False):
    """full_eval's outputs (vis_only's with `vis`: depth colormaps, the
    views' video and the flythrough too)."""
    assert np.isfinite(summary["psnr"]) and np.isfinite(summary["ssim"])
    names = os.listdir(os.path.join(exp_dir, "3views"))
    for i in range(views):
        for name in (f"image{i:03d}.jpg", f"depth_raw{i:03d}.npz") + (
                (f"depth_img{i:03d}.jpg",) if vis else ()):
            assert name in names, name
    for video in ("video.", "video360.") if vis else ():
        assert any(n.startswith(video) for n in names), video
    with open(os.path.join(exp_dir, "results.json")) as f:
        assert len(json.load(f)["psnr"]["views"]) == views


def test_vanilla_trains_resumes_and_evaluates(scene, tmp_path, tiny_cli,
                                              capsys):
    """`--exp_type vanilla` trains with the ray-buffer trainer (5 steps a
    call of 64 rays), checkpoints at its save interval, resumes, and
    full_eval / vis_only evaluate the newest checkpoint on the scene's
    val/ views; vis_only adds video.* and the video360 flythrough."""
    base = _argv("vanilla", scene, tmp_path, "--batch_size", "64",
                 "--save_every_steps", "10")
    state = cli.main(base + ["--run_max_steps", "10"])
    assert (state.step, state.opt.count) == (10, 10)
    assert len(state.params) == len(list(state.model.parameters()))
    exp = tmp_path / "exp"
    raw = torch.load(exp / "checkpoints" / "ckpt_00000010.pt",
                     weights_only=True)
    assert sorted(raw) == ["batch_stats", "opt", "params", "step"]
    with open(exp / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records if "loss" in r] == [5, 10]
    assert any("val_psnr" in r for r in records)
    assert os.path.exists(exp / "val_grid_00000010.png")

    state = cli.main(base + ["--run_max_steps", "15"])
    assert "resumed from checkpoint step 10" in capsys.readouterr().out
    assert state.step == 15

    summary = cli.main(base + ["--eval_mode", "full_eval"])
    assert "ckpt_00000010.pt" in capsys.readouterr().out
    _checks_eval(str(exp), summary, views=2)
    assert not any(n.startswith("video") for n in os.listdir(exp / "3views"))
    cfg = cli.parse_args(base + ["--eval_mode", "vis_only"])
    assert cli.run_eval(cfg, n_frames=3) == summary
    _checks_eval(str(exp), summary, views=2, vis=True)


def test_pixelnerf_trains_resumes_and_evaluates(scenes, tmp_path, tiny_cli,
                                                capsys):
    """`--exp_type pixelnerf` trains with the per-step trainer (one Adam
    over every parameter, the encoder included; BatchNorm statistics
    committed every step), resumes, and evaluates in both BatchNorm modes;
    vis_only writes video360."""
    base = _argv("pixelnerf", scenes, tmp_path, "--ray_batch_size", "16",
                 "--save_every_steps", "2")
    state = cli.main(base + ["--run_max_steps", "2"])
    assert (state.step, state.opt.count) == (2, 2)
    assert len(state.params) == len(list(state.model.parameters()))
    raw = torch.load(tmp_path / "exp" / "checkpoints" / "ckpt_00000002.pt",
                     weights_only=True)
    fresh = cli.build_model(cli.parse_args(base), "cpu")
    assert not torch.equal(raw["batch_stats"][
        "encoder.backbone.bn1.running_mean"],
        fresh.encoder.backbone.bn1.running_mean)
    state = cli.main(base + ["--run_max_steps", "4"])
    assert "resumed from checkpoint step 2" in capsys.readouterr().out
    assert (state.step, state.opt.count) == (4, 4)
    for bn in ("batch", "running"):
        summary = cli.main(base + ["--eval_mode", "full_eval",
                                   "--eval_bn_mode", bn])
        _checks_eval(str(tmp_path / "exp"), summary, views=2)
        with open(tmp_path / "exp" / "results.json") as f:
            assert json.load(f)["eval_bn_mode"] == bn
    cfg = cli.parse_args(base + ["--eval_mode", "vis_only"])
    summary = cli.run_eval(cfg, n_frames=2)
    _checks_eval(str(tmp_path / "exp"), summary, views=2, vis=True)


@pytest.mark.parametrize("exp_type", ["neo360", "neo360_fast"])
def test_vis_only_writes_the_flythrough(scenes, tmp_path, tiny_cli,
                                        exp_type):
    """vis_only for the NeO-360 models: the eval views, their video and a
    flythrough of scene 0, encoded once for every frame."""
    cfg = cli.parse_args(_argv(exp_type, scenes, tmp_path, "--eval_mode",
                               "vis_only"))
    summary = cli.run_eval(cfg, n_frames=2)
    _checks_eval(str(tmp_path / "exp"), summary, views=2, vis=True)


def test_render_trajectory_vanilla(scene, tmp_path):
    """vis_only's flythrough: spiral poses around the first test pose ->
    rays -> a video file (tests/test_cli.py:test_render_trajectory_vanilla)."""
    cfg = preset("vanilla", root_dir=scene, img_wh=(16, 12))
    ds = NeRDS360(scene, "test", (16, 12))
    seen = []

    def render_fn(sample):
        assert sample["rays_o"].shape == (16 * 12, 3)
        seen.append(sample["rays_o"][0])
        return {"rgb": torch.full((16 * 12, 3), 0.5)}

    path = cli._render_trajectory(cfg, render_fn, ds, str(tmp_path),
                                  n_frames=4)
    assert os.path.exists(path) and len(seen) == 4
    assert not np.allclose(seen[0], seen[1])


def test_render_trajectory_fewshot(scenes, tmp_path):
    """The few-shot flythrough's samples carry scene 0's test source stack
    and scene key (one encode serves every frame), and the camera moves
    (tests/test_cli.py:test_render_trajectory_fewshot)."""
    cfg = preset("pixelnerf", root_dir=scenes, img_wh=(16, 12))
    ds = NeRDS360AE(scenes, "test", (16, 12), 3)
    seen = []

    def render_fn(sample):
        for k in ("src_imgs", "src_poses", "src_focal", "src_c", "radii"):
            assert k in sample, k
        assert sample["scene_key"] == 0
        seen.append(np.asarray(sample["rays_o"][0]))
        return {"rgb": np.full((16 * 12, 3), 0.25, np.float32)}

    path = cli._render_trajectory(cfg, render_fn, ds, str(tmp_path),
                                  n_frames=3)
    assert os.path.exists(path) and len(seen) == 3
    assert not np.allclose(seen[0], seen[1])


def test_baselines_default_to_the_card(scene):
    """build_model and make_render_fn of the three baselines (vanilla,
    mipnerf360, pixelnerf) run on the card unless told otherwise (no CUDA
    here: they raise); with "cpu", build_model gives mipnerf360 at full
    width (8 x 1024 NeRF MLP, two 4 x 256 proposal MLPs)."""
    for exp_type in ("vanilla", "mipnerf360", "pixelnerf"):
        cfg = preset(exp_type, root_dir=scene)
        assert cfg.device == "cuda"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                cli.build_model(cfg)
            with pytest.raises(RuntimeError, match="CUDA"):
                cli.make_render_fn(cfg, None)
    mip = cli.build_model(preset("mipnerf360"), "cpu")
    assert tuple(mip.nerf_mlp.pts_7.weight.shape) == (1024, 1024)
    assert tuple(mip.nerf_mlp.pts_5.weight.shape) == (1024, 1024 + 504)
    assert tuple(mip.prop_mlp_1.pts_3.weight.shape) == (256, 256)
    assert (mip.num_prop_samples, mip.num_nerf_samples) == (64, 32)
    assert cli.parse_args(["--exp_type", "vanilla", "--root_dir", scene,
                           "--eval_mode", "vis_only"]).eval_mode == "vis_only"
