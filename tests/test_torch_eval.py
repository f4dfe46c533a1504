"""The port's whole few-shot eval slice against the JAX package: the
port's `cli.run_eval` (full_eval) on the fixture scenes at 40x30 with a
cut-down neo360_fast model, on weights exported from JAX `model.init` as
npz, against the JAX `make_render_fn` on the same weights.

Tolerances: rgb 1e-4 absolute per pixel (float32, different summation
orders in the convolutions and matmuls); PSNR 0.01 dB per view; the depth
colormap JPEGs (depth_img*.jpg) 8 of 255 per pixel and channel, 0.25 on
average (a 1e-4 depth difference can move a pixel across one of the 256
levels before the JET map, and JPEG spreads that over its 8x8 block).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo360_tpu import cli as jcli
from neo360_tpu.config import preset as jpreset
from neo360_tpu.data.nerds360_ae import NeRDS360AE as JNeRDS360AE
from neo360_tpu.models.neo360 import NeRFTP as JNeRFTP
from neo360_tpu.train import metrics as jmetrics
from neo360_tpu.utils.io import save_variables_npz
from neo360_tpu_torch import cli
from neo360_tpu_torch.config import preset

torch.set_num_threads(1)

TINY = dict(grid_size=(8, 8, 4), encoder_width=64, lift_dim=32,
            num_prop_samples=8, num_fine_samples=6)
WH = (40, 30)
SRC = ("src_imgs", "src_poses", "src_focal", "src_c")
RAYS = ("rays_o", "rays_d", "viewdirs")


@pytest.fixture(scope="module")
def jax_side(multi_scene_root):
    model = JNeRFTP(num_src_views=3, use_proposal=True, remat_encoder=False,
                    **TINY)
    ds = JNeRDS360AE(multi_scene_root, "test", WH, 3)
    s0 = ds.sample_test(0, 0)
    rays = {k: jnp.asarray(s0[k][:4] if k in RAYS else s0[k])
            for k in RAYS + SRC}
    variables = jax.jit(lambda r: model.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        r, True, False))(rays)
    render_fn = jcli.make_render_fn(
        jpreset("neo360_fast", bf16=False, img_wh=WH), model,
        scene_cache=True)
    views = []
    for s in range(len(ds.scene_ids)):
        for d in range(len(ds.scene_meta(ds.scene_ids[s]).c2w_test)):
            sample = dict(ds.sample_test(s, d), scene_key=s)
            out = render_fn(variables, sample)
            target = jnp.asarray(sample["target"])
            views.append((sample, np.asarray(out["rgb"]),
                          np.asarray(out["depth"]),
                          float(jmetrics.psnr(out["rgb"], target))))
    return variables, views


def _cfg(root, tmp_path, **kw):
    return preset("neo360_fast", bf16=False, root_dir=root, img_wh=WH,
                  eval_mode="full_eval", ckpt_dir=str(tmp_path), **TINY,
                  **kw)


def test_run_eval_matches_jax(multi_scene_root, tmp_path, jax_side, capsys):
    variables, views = jax_side
    npz = save_variables_npz(str(tmp_path / "jax_vars.npz"), variables)
    cfg = _cfg(multi_scene_root, tmp_path, ckpt_path=npz)

    summary = cli.run_eval(cfg, device="cpu")
    assert "WARNING" not in capsys.readouterr().out
    exp_dir = tmp_path / "exp"
    with open(exp_dir / "results.json") as f:
        results = json.load(f)
    assert results["eval_bn_mode"] == "batch"
    assert results["psnr"]["mean"] == pytest.approx(summary["psnr"])
    n = len(views)
    assert sorted(os.listdir(exp_dir / "3views")) == sorted(
        [f"image{i:03d}.jpg" for i in range(n)]
        + [f"depth_raw{i:03d}.npz" for i in range(n)]
        + [f"depth_img{i:03d}.jpg" for i in range(n)])
    # every view run_eval rendered: PSNR and the raw depth it wrote
    assert len(results["psnr"]["views"]) == n
    for i, (_, _, jdepth, jpsnr) in enumerate(views):
        assert abs(results["psnr"]["views"][i] - jpsnr) < 0.01
        depth = np.load(exp_dir / "3views" / f"depth_raw{i:03d}.npz")["depth"]
        np.testing.assert_allclose(depth.reshape(-1), jdepth, atol=1e-4)
    assert abs(summary["psnr"] - np.mean([v[3] for v in views])) < 0.01

    # rgb of the first view of each scene through the same render_fn
    model = cli.build_model(cfg, "cpu")
    assert cli.restore(cfg, model, str(exp_dir)) == npz
    render_fn = cli.make_render_fn(cfg, model, "cpu")
    keys = [v[0]["scene_key"] for v in views]
    firsts = [v for i, v in enumerate(views) if keys.index(keys[i]) == i]
    assert len(firsts) == 3
    for sample, jrgb, _, _ in firsts:
        rgb = render_fn(sample)["rgb"]
        np.testing.assert_allclose(rgb.numpy(), jrgb, atol=1e-4)


def test_full_eval_depth_colormaps_match_jax(multi_scene_root, tmp_path,
                                             jax_side):
    """full_eval writes depth_img{i}.jpg for every view with depth, as the
    JAX `evaluate_and_save` does whatever the eval mode, each scaled by
    the largest depth of the set: the port's files against the JAX
    writer's on the JAX renders of the same weights."""
    import cv2

    from neo360_tpu.train.eval import evaluate_and_save as jevaluate_and_save
    variables, views = jax_side
    npz = save_variables_npz(str(tmp_path / "jax_vars.npz"), variables)
    cli.run_eval(_cfg(multi_scene_root, tmp_path, ckpt_path=npz),
                 device="cpu")
    rendered = iter(views)

    def replay(sample):
        _, rgb, depth, _ = next(rendered)
        return {"rgb": jnp.asarray(rgb), "depth": jnp.asarray(depth)}

    jdir = tmp_path / "jax_eval"
    jevaluate_and_save(replay, [v[0] for v in views], WH, str(jdir))
    for i in range(len(views)):
        ours = cv2.imread(str(tmp_path / "exp" / "3views"
                              / f"depth_img{i:03d}.jpg")).astype(np.int16)
        ref = cv2.imread(str(jdir / f"depth_img{i:03d}.jpg")).astype(
            np.int16)
        assert ours.shape == ref.shape == (WH[1], WH[0], 3)
        diff = np.abs(ours - ref)
        assert diff.max() <= 8 and diff.mean() <= 0.25, (i, diff.max(),
                                                         diff.mean())


def test_restore_port_checkpoint(tmp_path):
    """A port checkpoint (torch state_dict) in the experiment directory is
    loaded when no --ckpt_path is given."""
    cfg = _cfg("unused", tmp_path, seed=3)
    saved = cli.build_model(cfg, "cpu")
    os.makedirs(tmp_path / "exp")
    torch.save(saved.state_dict(), tmp_path / "exp" / "model.pt")
    model = cli.build_model(_cfg("unused", tmp_path, seed=4), "cpu")
    assert cli.restore(cfg, model, str(tmp_path / "exp")).endswith(
        "model.pt")
    for k, v in saved.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_run_eval_without_checkpoint_evaluates_random_init(tmp_path,
                                                           capsys):
    from neo360_tpu.data.fixtures import make_micro_scene
    root = tmp_path / "scenes"
    make_micro_scene(str(root / "scene_000"), n_val=1, wh=WH)
    summary = cli.run_eval(_cfg(str(root), tmp_path, eval_bn_mode="running"),
                           device="cpu")
    out = capsys.readouterr().out
    assert "WARNING: no checkpoint found; evaluating random init" in out
    assert "eval encode BN mode: running" in out
    assert np.isfinite(summary["psnr"]) and np.isfinite(summary["ssim"])


def test_parse_args_matches_jax_cli():
    """The port's CLI builds the same neo360_fast config as the JAX CLI,
    for eval and for training flags, except bf16: the JAX CLI's `--bf16`
    flag defaults to False and overrides the preset's bf16=True; the port
    keeps the preset's value. For neo360, under its name and the
    reference's alias, the two configs are the same."""
    import dataclasses
    argv = ["--exp_type", "neo360_fast", "--root_dir", "/data",
            "--eval_mode", "full_eval", "--render_name", "3views_test",
            "--eval_bn_mode", "running"]
    cfg, ref = cli.parse_args(argv), jcli.parse_args(argv + ["--bf16"])
    for f in dataclasses.fields(ref):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    assert (cfg.bf16, cfg.lift_dim, cfg.num_fine_samples, cfg.chunk,
            cfg.num_src_views) == (True, 128, 60, 256, 3)
    train = argv[:4] + ["--run_max_steps", "640", "--stage_k", "16",
                        "--save_every_steps", "320", "--ray_batch_size",
                        "400", "--lr_init", "1e-3"]
    cfg, ref = cli.parse_args(train), jcli.parse_args(train + ["--bf16"])
    for f in dataclasses.fields(ref):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    if not torch.cuda.is_available():   # training runs on cuda by default
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv[:4])
    for exp_type in ("neo360", "triplanar_nocs_fusion_conv_scene"):
        argv = ["--exp_type", exp_type, "--root_dir", "/data"]
        cfg, ref = cli.parse_args(argv), jcli.parse_args(argv)
        for f in dataclasses.fields(ref):
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
        assert (cfg.exp_type, cfg.bf16, cfg.stage_k, cfg.lift_dim,
                cfg.grad_max_norm) == ("neo360", False, 0, None, 0.05)


@pytest.mark.parametrize("exp_type", ["neo360_fast", "pixelnerf",
                                      "vanilla", "mipnerf360"])
def test_parse_args_bf16_flag(exp_type):
    """`--bf16` parses as in the JAX CLI and turns bf16 on; without it the
    preset's value stands (the JAX CLI's False default would override a
    bf16 preset, the divergence test_parse_args_matches_jax_cli records).
    With the flag both CLIs build the same config."""
    import dataclasses
    argv = ["--exp_type", exp_type, "--root_dir", "/data"]
    assert cli.parse_args(argv).bf16 == preset(exp_type).bf16
    cfg, ref = cli.parse_args(argv + ["--bf16"]), jcli.parse_args(
        argv + ["--bf16"])
    assert cfg.bf16 is True
    for f in dataclasses.fields(ref):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
