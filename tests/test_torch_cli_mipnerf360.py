"""The port's CLI for MipNeRF-360 on the CPU at a tiny size (40x30 micro
scene written by the port's fixture writer, NeRF MLP 8 x 32, proposal
MLPs 2 x 32, 8 + 8 + 4 samples): training with the ray-buffer trainer and
the step count's anneal, checkpoint and resume, full_eval against the JAX
CLI's renderer on the same weights (PSNR within 0.01 dB per view), and
vis_only. The CLI has no size flags: `parse_args` is wrapped to apply the
tiny sample counts and the model's constructor to apply the tiny widths.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo360_tpu import cli as jcli
from neo360_tpu.config import preset as jpreset
from neo360_tpu.models.mipnerf360 import MipNeRF360 as JMipNeRF360
from neo360_tpu.train import metrics as jmetrics
from neo360_tpu.utils.io import save_variables_npz
from neo360_tpu_torch import cli
from neo360_tpu_torch.data.fixtures import make_micro_scene
from neo360_tpu_torch.data.nerds360 import NeRDS360
from neo360_tpu_torch.models import mipnerf360

torch.set_num_threads(1)

WH = (40, 30)
WIDTHS = dict(nerf_netwidth=32, prop_netdepth=2, prop_netwidth=32)
SAMPLES = dict(num_prop_samples=8, num_fine_samples=4)


@pytest.fixture
def tiny_cli(monkeypatch):
    """parse_args with the tiny sample counts; the model at the tiny
    widths; every train_frac the model is given, in order."""
    parse = cli.parse_args
    monkeypatch.setattr(cli, "parse_args", lambda argv: parse(argv).replace(
        steps_per_call=2, **SAMPLES))
    model = mipnerf360.MipNeRF360
    seen = []

    class Tiny(model):
        __init__ = functools.partialmethod(model.__init__, **WIDTHS)

        def forward(self, rays, train_frac, *args, **kw):
            seen.append(train_frac)
            return super().forward(rays, train_frac, *args, **kw)

    monkeypatch.setattr(mipnerf360, "MipNeRF360", Tiny)
    return seen


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_micro_scene(str(tmp_path_factory.mktemp("scene")), n_val=2,
                            wh=WH)


def _argv(root, ckpt_dir, *extra):
    return ["--exp_type", "mipnerf360", "--root_dir", root, "--img_wh",
            "40", "30", "--ckpt_dir", str(ckpt_dir), "--device", "cpu",
            "--chunk", "600", "--batch_size", "32", *extra]


def test_mipnerf360_trains_with_the_anneal_and_resumes(scene, tmp_path,
                                                       tiny_cli, capsys):
    """`--exp_type mipnerf360` trains with the ray-buffer trainer (2 steps
    a call of 32 rays with radii), anneals by the step count before each
    step (train_frac = step / 1e6), checkpoints at its save interval and
    resumes from it with the train_frac an uninterrupted run gives."""
    base = _argv(scene, tmp_path, "--save_every_steps", "4")
    state = cli.main(base + ["--run_max_steps", "4"])
    assert (state.step, state.opt.count) == (4, 4)
    assert len(state.params) == len(list(state.model.parameters()))
    exp = tmp_path / "exp"
    with open(exp / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records if "loss" in r] == [2, 4]
    assert all(np.isfinite(r["loss"]) for r in records if "loss" in r)
    assert any(np.isfinite(r.get("val_psnr", np.nan)) for r in records)
    assert os.path.exists(exp / "checkpoints" / "ckpt_00000004.pt")
    state = cli.main(base + ["--run_max_steps", "6"])
    assert "resumed from checkpoint step 4" in capsys.readouterr().out
    assert (state.step, state.opt.count) == (6, 6)
    # training forwards (the validation render at step 4 passes 1.0)
    train = [f for f in tiny_cli if f != 1.0]
    assert train == [s / 1e6 for s in range(6)]
    fresh = cli.main(_argv(scene, tmp_path / "fresh", "--save_every_steps",
                           "100", "--run_max_steps", "6"))
    assert fresh.step == 6
    assert [f for f in tiny_cli if f != 1.0][6:] == train


@pytest.fixture(scope="module")
def jax_weights(scene, tmp_path_factory):
    """A tiny JAX MipNeRF360, its variables and their npz."""
    model = JMipNeRF360(num_prop_samples=8, num_nerf_samples=4, **WIDTHS)
    sample = NeRDS360(scene, "test", WH).image_rays(0)
    rays = {k: jnp.asarray(sample[k][:4]) for k in cli.MIP_RAY_KEYS}
    variables = jax.jit(lambda r: model.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        r, 1.0, False, 0.2, 3.0))(rays)
    path = save_variables_npz(str(tmp_path_factory.mktemp("w") / "v.npz"),
                              variables)
    return model, variables, path


def test_mipnerf360_full_eval_matches_jax(scene, tmp_path, tiny_cli,
                                          jax_weights):
    """full_eval of the scene's 2 test views from a JAX npz (--ckpt_path):
    each view's PSNR within 0.01 dB of the JAX CLI's renderer on the same
    weights and rays."""
    model, variables, path = jax_weights
    summary = cli.main(_argv(scene, tmp_path, "--eval_mode", "full_eval",
                             "--ckpt_path", path))
    with open(tmp_path / "exp" / "results.json") as f:
        views = json.load(f)["psnr"]["views"]
    assert len(views) == 2 and np.isfinite(summary["ssim"])
    render = jcli.make_render_fn(jpreset("mipnerf360", img_wh=WH,
                                         chunk=600), model)
    test_ds = NeRDS360(scene, "test", WH)
    for i, ours in enumerate(views):
        sample = test_ds.image_rays(i)
        out = render(variables, sample)
        ref = float(jmetrics.psnr(out["rgb"], jnp.asarray(sample["target"])))
        assert abs(ours - ref) < 0.01, (i, ours, ref)


def test_mipnerf360_vis_only_writes_the_flythrough(scene, tmp_path,
                                                   tiny_cli, jax_weights):
    """vis_only: the test views with their depth images, their video and
    a 2-frame flythrough around the first test pose."""
    cfg = cli.parse_args(_argv(scene, tmp_path, "--eval_mode", "vis_only",
                               "--ckpt_path", jax_weights[2]))
    summary = cli.run_eval(cfg, n_frames=2)
    assert np.isfinite(summary["psnr"])
    names = os.listdir(tmp_path / "exp" / "3views")
    for name in ("image000.jpg", "image001.jpg", "depth_img001.jpg"):
        assert name in names, name
    for video in ("video.", "video360."):
        assert any(n.startswith(video) for n in names), video


def test_buffer_trainer_draws_ignore_the_radii(scene):
    """The ray buffers now carry the pixel radii; the buffer trainer draws
    the same rows from the same generator with or without them, so the
    vanilla NeRF's batches are unchanged."""
    from neo360_tpu_torch.train import loop
    buffers = NeRDS360(scene, "train", WH).ray_buffers()
    assert buffers["radii"].shape == (buffers["target"].shape[0], 1)
    seen = {}
    for name, bufs in (("with", buffers),
                       ("without", {k: v for k, v in buffers.items()
                                    if k != "radii"})):
        rows = seen.setdefault(name, [])
        run = loop.make_buffer_trainer(
            lambda state, batch, gen: rows.append(batch["target"]), 16, 3)
        run(None, bufs, torch.Generator().manual_seed(5))
    for a, b in zip(seen["with"], seen["without"]):
        assert torch.equal(a, b)
