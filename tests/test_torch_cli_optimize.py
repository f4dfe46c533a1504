"""The port's optimize and LPIPS-finetune modes through its CLI, on the
CPU at a tiny size (neo360: grid (8, 8, 8), encoder width 64, 8 coarse
and 6 fine samples; neo360_fast: grid (8, 8, 4), lift 32, 8 proposal and
6 fine samples; float32, 40x30 fixture scenes, 16 rays a step,
tri-planes shrunk to 30x40), mirroring tests/test_cli.py's optimize and
finetune tests: the cached latents, the frozen SpatialEncoder, the
refusal without LPIPS weights, the freeze's optimizer, the latents built
from the restored weights, and besides keep_all, --resnet_weights and
run_eval --lpips_weights. The CLI has no size flags, so `parse_args` is
wrapped to apply the tiny sizes.
"""

import json

import numpy as np
import pytest
import torch

from neo360_tpu_torch import cli, weights
from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE
from neo360_tpu_torch.nn.lpips import random_torch_state
from neo360_tpu_torch.nn.triplane import GridEncoder
from neo360_tpu_torch.train.checkpoints import CheckpointManager

torch.set_num_threads(1)

WH = (40, 30)
TINY = {"neo360": dict(grid_size=(8, 8, 8), encoder_width=64,
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
def root(tmp_path_factory):
    from neo360_tpu.data.fixtures import make_micro_scene
    path = tmp_path_factory.mktemp("scenes")
    for s in range(2):
        make_micro_scene(str(path / f"scene_{s:03d}"), n_val=1, wh=WH,
                         seed=100 + s)
    return str(path)


def _argv(exp_type, root, ckpt_dir, *extra):
    return ["--exp_type", exp_type, "--root_dir", root, "--img_wh", "40",
            "30", "--ckpt_dir", str(ckpt_dir), "--device", "cpu",
            "--ray_batch_size", "16", *extra]


@pytest.fixture(scope="module")
def warm(tmp_path_factory):
    """A warm-start file: a neo360 model's weights, each entry times
    1 + 0.05 N(0, 1) (running variances times 1.1, running means plus
    0.01), so that they differ from the seeded initialisation."""
    cfg = cli.preset("neo360", **TINY["neo360"])
    g = torch.Generator().manual_seed(9)
    sd = {}
    for k, v in cli.build_model(cfg, "cpu").state_dict().items():
        if k.endswith("running_var"):
            sd[k] = v * 1.1
        elif k.endswith("running_mean"):
            sd[k] = v + 0.01
        else:
            sd[k] = v * (1 + 0.05 * torch.randn(v.shape, generator=g))
    path = str(tmp_path_factory.mktemp("warm") / "warm.pt")
    torch.save(sd, path)
    return path


def test_optimize_caches_latents_and_keeps_every_checkpoint(root, tmp_path,
                                                            tiny_cli,
                                                            capsys):
    """--is_optimize through cli.main caches the frozen spatial-encoder
    latents once per scene and trains against them with the per-step
    trainer, whatever --stage_k says; steps advance and log, and every
    checkpoint is kept (keep_all: 7 saves, more than the newest + 5 best
    a normal run keeps)."""
    state = cli.main(_argv("neo360_fast", root, tmp_path, "--is_optimize",
                           "--stage_k", "32", "--run_max_steps", "7",
                           "--save_every_steps", "1"))
    out = capsys.readouterr().out
    assert out.count("cached frozen spatial-encoder latents for 2 "
                     "scene(s)") == 1
    assert state.step == 7 and state.opt.count == 7
    assert hasattr(state, "opt")            # the per-step trainer's state
    steps = CheckpointManager(str(tmp_path / "exp" / "checkpoints")).steps()
    assert steps == list(range(1, 8))
    records = [json.loads(line) for line in
               open(tmp_path / "exp" / "metrics.jsonl")]
    assert [r["step"] for r in records if "val_psnr" in r] == \
        list(range(1, 8))
    assert all(np.isfinite(r["val_psnr"]) for r in records)


def test_checkpoint_retention_with_and_without_keep_all(tmp_path):
    """The newest checkpoint plus the 5 best by val_psnr, or with
    keep_all every one."""
    for keep_all in (False, True):
        mgr = CheckpointManager(str(tmp_path / str(keep_all)), keep_all)
        for step in range(1, 9):
            mgr.save(step, {"step": step}, {"val_psnr": float(step % 4)})
        # scores 1 2 3 0 1 2 3 0: the newest (8) and the 5 best, ties
        # broken by the older step, each save evicting what it must
        assert mgr.steps() == (list(range(1, 9)) if keep_all
                               else [1, 2, 3, 6, 7, 8])


@pytest.mark.parametrize("flag", ["--is_optimize", "--finetune_lpips"])
def test_frozen_modes_freeze_the_spatial_encoder(root, tmp_path, tiny_cli,
                                                 warm, flag):
    """--is_optimize and --finetune_lpips (neo360, warm-started) leave
    every SpatialEncoder parameter and every BatchNorm buffer as the warm
    start had them, bit for bit, while the rest of the model trains; the
    optimizer holds the trained parameters only, at lr 5e-6."""
    extra = [flag, "--ckpt_path", warm, "--run_max_steps", "2",
             "--save_every_steps", "2"]
    if flag == "--finetune_lpips":
        lp = str(tmp_path / "lpips.pt")
        torch.save(random_torch_state(0), lp)
        extra += ["--lpips_weights", lp]
    state = cli.main(_argv("neo360", root, tmp_path, *extra))
    before = torch.load(warm, weights_only=True)
    after = state.model.state_dict()
    frozen = [k for k in before if "spatial_encoder" in k
              or k.endswith(("running_mean", "running_var"))]
    assert all(torch.equal(before[k], after[k]) for k in frozen)
    moved = [k for k in before if k not in frozen
             and not torch.equal(before[k], after[k])]
    assert len(moved) > 0.8 * (len(before) - len(frozen))
    assert not any("spatial_encoder" in k for k in state.params)
    assert len(state.opt.params) == len(state.params) > 0
    assert state.opt.lr(0) == state.opt.lr(10 ** 6) == 5e-6
    assert not state.model.training


def test_finetune_lpips_requires_weights(root, tmp_path, tiny_cli):
    """--finetune_lpips without pretrained LPIPS weights raises: the LPIPS
    term is stage 2, and without it the run would be stage 1 at a pinned
    lr."""
    for extra in ([], ["--lpips_weights", str(tmp_path / "missing.pt")]):
        with pytest.raises(ValueError, match="lpips_weights"):
            cli.main(_argv("neo360", root, tmp_path, "--finetune_lpips",
                           *extra))


def test_finetune_trains_on_square_patches(root, tmp_path, tiny_cli):
    """The finetune's step is one 30x30 patch (900 rays) with the LPIPS
    term: its logged loss exceeds the MSE-based loss of the same step
    without it, and a non-square batch raises."""
    lp = str(tmp_path / "lpips.pt")
    torch.save(random_torch_state(0), lp)
    cfg = cli.parse_args(_argv("neo360_fast", root, tmp_path,
                               "--finetune_lpips", "--lpips_weights", lp))
    from neo360_tpu_torch.nn.lpips import LPIPSModel
    model = cli.build_model(cfg, "cpu").eval()
    ds = NeRDS360AE(root, "train", WH, 3, 16, finetune_lpips=True)
    batch = {k: torch.as_tensor(v) for k, v in
             ds.sample_train(np.random.default_rng(0)).items()
             if k in cli.STEP_KEYS}
    assert batch["target"].shape == (900, 3)
    results = []
    for lpips in (LPIPSModel(lp), None):
        loss_fn = cli.make_loss_fn(cfg, model, randomized=False,
                                   lpips_model=lpips)
        with torch.no_grad():
            results.append(float(loss_fn(batch, None)[0]))
    assert results[0] > results[1]
    loss_fn = cli.make_loss_fn(cfg, model, randomized=False,
                               lpips_model=LPIPSModel(lp))
    odd = {k: v[:899] if v.shape[0] == 900 else v for k, v in batch.items()}
    with pytest.raises(ValueError, match="square"):
        loss_fn(odd, None)


def test_optimize_latents_come_from_the_restored_weights(root, tmp_path,
                                                         tiny_cli, warm,
                                                         monkeypatch):
    """The optimize mode caches its latents after the warm start (and the
    resume): they are the warm start's SpatialEncoder's latents of each
    scene's fixed source stack, not the fresh initialisation's."""
    seen = []
    real = cli._optimize_latents

    def recording(model, ds, device):
        seen.append(real(model, ds, device)["pixel_latents"])
        return {"pixel_latents": seen[-1]}

    monkeypatch.setattr(cli, "_optimize_latents", recording)
    cli.main(_argv("neo360", root, tmp_path, "--is_optimize", "--ckpt_path",
                   warm, "--run_max_steps", "1"))
    cfg = cli.parse_args(_argv("neo360", root, tmp_path))
    ds = NeRDS360AE(root, "train", WH, 3, 16, optimize=True)
    imgs = torch.as_tensor(ds.optimize_source_stack(1)["src_imgs"])
    fresh = cli.build_model(cfg, "cpu")
    restored = cli.build_model(cfg, "cpu")
    weights.load_into(restored, torch.load(warm, weights_only=True))
    with torch.no_grad():
        want = restored.encode_images(imgs)
        init = fresh.encode_images(imgs)
    (lat,) = seen
    assert lat.shape[0] == 2 and torch.equal(lat[1], want)
    assert not torch.allclose(lat[1], init)


def test_resnet_weights_load_into_the_backbone(root, tmp_path, tiny_cli,
                                               capsys):
    """--resnet_weights (a resnet34 state dict in the torchvision layout)
    fills every backbone entry of the SpatialEncoder and says how many."""
    from test_torch_lpips import _resnet34_state
    sd = _resnet34_state(2)
    path = str(tmp_path / "resnet34.pth")
    torch.save(sd, path)
    state = cli.main(_argv("neo360", root, tmp_path, "--resnet_weights",
                           path, "--run_max_steps", "0"))
    backbone = state.model.encoder.spatial_encoder.backbone.state_dict()
    assert f"loaded {len(backbone)} pretrained ResNet34 arrays" in \
        capsys.readouterr().out
    assert torch.equal(backbone["layer3_5.bn2.running_var"],
                       sd["layer3.5.bn2.running_var"])
    assert torch.equal(backbone["layer2_0.downsample_conv.weight"],
                       sd["layer2.0.downsample.0.weight"])


def test_run_eval_reports_lpips(root, tmp_path, tiny_cli):
    """run_eval --lpips_weights puts each view's LPIPS into the summary
    and results.json."""
    lp = str(tmp_path / "lpips.pt")
    torch.save(random_torch_state(0), lp)
    summary = cli.main(_argv("neo360_fast", root, tmp_path, "--eval_mode",
                             "full_eval", "--lpips_weights", lp))
    payload = json.load(open(tmp_path / "exp" / "results.json"))
    assert np.isfinite(summary["lpips"]) and summary["lpips"] > 0
    assert len(payload["lpips"]["views"]) == len(payload["psnr"]["views"])
    assert "lpips_status" not in payload
