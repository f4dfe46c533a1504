"""The port's CLI on its new entry points, on the CPU at a tiny size
(grid (8, 8, 8), encoder width 64, 8 coarse and 6 fine samples for
neo360; grid (8, 8, 4), lift 32, 8 proposal and 6 fine samples for
neo360_fast; 40x30 fixture scenes, 16 rays a step, float32, tri-planes
shrunk to 30x40): the per-step trainer of the neo360 preset with its
checkpoints, resume, warm start and evaluation; the refusal to resume
across trainer layouts; the stage trainer's per-step warm-up; and the
eval loop's host prefetch and LPIPS refusal. The CLI has no size flags,
so `parse_args` is wrapped to apply the tiny sizes.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from neo360_tpu_torch import cli, weights
from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE
from neo360_tpu_torch.nn.triplane import GridEncoder

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


def test_neo360_trains_checkpoints_resumes_and_evaluates(root, tmp_path,
                                                         tiny_cli, capsys):
    """`--exp_type neo360` trains with the per-step trainer (one Adam over
    all parameters), checkpoints the per-step layout, resumes from it, and
    --eval_mode full_eval evaluates the newest checkpoint."""
    base = _argv("neo360", root, tmp_path, "--save_every_steps", "2")
    state = cli.main(base + ["--run_max_steps", "2"])
    assert (state.step, state.opt.count) == (2, 2)
    assert len(state.opt.params) == len(list(state.model.parameters()))
    exp = tmp_path / "exp"
    raw = torch.load(exp / "checkpoints" / "ckpt_00000002.pt",
                     weights_only=True)
    assert sorted(raw) == ["batch_stats", "opt", "params", "step"]
    assert raw["step"] == 2 and raw["opt"]["count"] == 2

    state = cli.main(base + ["--run_max_steps", "4"])
    assert "resumed from checkpoint step 2" in capsys.readouterr().out
    assert (state.step, state.opt.count) == (4, 4)
    records = [json.loads(line) for line in open(exp / "metrics.jsonl")]
    assert [r["step"] for r in records if "val_psnr" in r] == [2, 4]
    assert all(np.isfinite(r["mse"]) and np.isfinite(r["psnr"])
               for r in records if "mse" in r)

    summary = cli.main(base + ["--eval_mode", "full_eval"])
    out = capsys.readouterr().out
    assert "ckpt_00000004.pt" in out and "WARNING" not in out
    assert np.isfinite(summary["psnr"]) and np.isfinite(summary["ssim"])
    raw = torch.load(exp / "checkpoints" / "ckpt_00000004.pt",
                     weights_only=True)
    model = cli.build_model(cli.parse_args(base), "cpu")
    cli.restore(cli.parse_args(base), model, str(exp))
    for k, v in model.state_dict().items():
        assert torch.equal(v, {**raw["params"], **raw["batch_stats"]}[k]), k


@pytest.fixture(scope="module")
def stage_ckpt(root, tmp_path_factory):
    """A neo360_fast stage-trainer run of one K=2 stage and its
    checkpoint."""
    parse = cli.parse_args
    plane_hw = GridEncoder.plane_hw
    cli.parse_args = lambda argv: parse(argv).replace(**TINY["neo360_fast"])
    GridEncoder.plane_hw = (30, 40)
    try:
        ckpts = tmp_path_factory.mktemp("stage_ckpts")
        cli.main(_argv("neo360_fast", root, ckpts, "--stage_k", "2",
                       "--save_every_steps", "2", "--run_max_steps", "2"))
    finally:
        cli.parse_args, GridEncoder.plane_hw = parse, plane_hw
    return ckpts, ckpts / "exp" / "checkpoints" / "ckpt_00000002.pt"


def test_resuming_across_trainer_layouts_raises(root, stage_ckpt, tiny_cli):
    """A stage-layout run resumed with --stage_k 0 (the per-step trainer)
    raises with the JAX CLI's message instead of loading half a state."""
    ckpts, _ = stage_ckpt
    with pytest.raises(ValueError, match="trainer-layout change"):
        cli.main(_argv("neo360_fast", root, ckpts, "--stage_k", "0",
                       "--save_every_steps", "2", "--run_max_steps", "4"))


def test_warm_start_from_a_stage_checkpoint(root, stage_ckpt, tmp_path,
                                            tiny_cli, capsys):
    """--ckpt_path in training loads another run's stage checkpoint into
    the fresh model (parameters and BatchNorm buffers) and starts at step
    0 with fresh optimizers, for the stage trainer and the per-step
    trainer (neo360_fast with --stage_k 0: the proposal loss)."""
    _, path = stage_ckpt
    raw = torch.load(path, weights_only=True)
    saved = weights.from_checkpoint(raw)
    for k_flag in ("2", "0"):
        state = cli.main(_argv("neo360_fast", root, tmp_path / k_flag,
                               "--stage_k", k_flag, "--ckpt_path", str(path),
                               "--run_max_steps", "0"))
        assert "warm-started" in capsys.readouterr().out
        assert state.step == 0
        for k, v in state.model.state_dict().items():
            assert torch.equal(v, saved[k]), k
    assert state.opt.count == 0
    state = cli.main(_argv("neo360_fast", root, tmp_path / "steps",
                           "--stage_k", "0", "--ckpt_path", str(path),
                           "--run_max_steps", "1"))
    assert (state.step, state.opt.count) == (1, 1)


def test_warm_start_from_a_jax_npz(root, tmp_path, tiny_cli, capsys):
    """--ckpt_path x.npz (a JAX export of the neo360 model) warm-starts the
    per-step trainer at step 0 with exactly the converted weights."""
    import jax
    import jax.numpy as jnp

    from neo360_tpu.models.neo360 import NeRFTP as JNeRFTP
    from neo360_tpu.utils.io import save_variables_npz
    sample = NeRDS360AE(root, "test", WH, 3).sample_test(0, 0)
    model = JNeRFTP(num_src_views=3, use_proposal=False, remat_encoder=False,
                    **TINY["neo360"])
    rays = {k: jnp.asarray(v[:4] if k in cli.RAY_KEYS else v)
            for k, v in sample.items() if k in cli.RAY_KEYS + cli.SRC_KEYS}
    variables = jax.jit(lambda r: model.init(
        {"params": jax.random.PRNGKey(3), "sampling": jax.random.PRNGKey(4)},
        r, True, False))(rays)
    npz = save_variables_npz(str(tmp_path / "vars.npz"), variables)
    state = cli.main(_argv("neo360", root, tmp_path, "--ckpt_path", npz,
                           "--run_max_steps", "0"))
    assert "warm-started" in capsys.readouterr().out and state.step == 0
    ref = weights.from_flax_flat(weights.load_variables_npz(npz))
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, ref[k]), k


@pytest.mark.parametrize("exp_type", ["neo360_fast", "neo360"])
def test_stage_warmup_runs_per_step_steps_then_stages(root, tmp_path,
                                                      tiny_cli, capsys,
                                                      exp_type):
    """--stage_warmup_steps 2 with --stage_k 2: two per-step steps, then
    one stage of the stage trainer from step 2 to step 4, for the proposal
    model and for neo360 (five tables: 3 planes, the coarse and the fine
    local table)."""
    state = cli.main(_argv(exp_type, root, tmp_path, "--stage_k", "2",
                           "--stage_warmup_steps", "2", "--save_every_steps",
                           "2", "--run_max_steps", "4"))
    assert "stage warmup: 2 per-step-encode steps done" in \
        capsys.readouterr().out
    assert (state.step, state.enc_opt.count, state.ray_opt.count) == (4, 1, 2)
    records = [json.loads(line) for line in
               open(tmp_path / "exp" / "metrics.jsonl")]
    assert [r["step"] for r in records if "psnr" in r] == [2]
    assert [r["step"] for r in records if "val_psnr" in r] == [4]
    assert os.path.exists(tmp_path / "exp" / "checkpoints" /
                          "ckpt_00000004.pt")


def test_run_eval_prefetches_samples_on_a_thread(root, tmp_path, tiny_cli,
                                                 monkeypatch):
    """run_eval makes each view's sample (rays and target) on the
    prefetcher's worker thread, as the JAX run_eval does, not in line."""
    threads = []
    sample_test = NeRDS360AE.sample_test

    def recording(self, *args):
        threads.append(threading.current_thread())
        return sample_test(self, *args)

    monkeypatch.setattr(NeRDS360AE, "sample_test", recording)
    summary = cli.main(_argv("neo360_fast", root, tmp_path, "--eval_mode",
                             "full_eval"))
    assert np.isfinite(summary["psnr"])
    ds = NeRDS360AE(root, "test", WH, 3)
    assert len(threads) == sum(ds.num_test_views(s)
                               for s in range(len(ds.scene_ids))) > 0
    assert all(t is not threading.main_thread() for t in threads)


def test_run_eval_refuses_lpips_weights(tmp_path):
    """--lpips_weights in eval raises until LPIPS is ported, instead of
    writing results without it."""
    cfg = cli.parse_args(["--exp_type", "neo360_fast", "--root_dir",
                          str(tmp_path), "--eval_mode", "full_eval",
                          "--lpips_weights", "lpips.npz", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="lpips"):
        cli.run_eval(cfg)


@pytest.mark.parametrize("exp_type,device,off", [
    ("neo360", "cuda", True), ("neo360", "cpu", False),
    ("neo360_fast", "cuda", False)])
def test_float32_matmuls_turns_tf32_off_for_float32_on_the_card(
        monkeypatch, capsys, exp_type, device, off):
    """run_train and run_eval call it: a float32 config on a CUDA device
    turns TF32 off (and says so); a CPU device or a bf16 config leaves the
    flags alone. Only the device's type is read, so no card is needed."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    cfg = cli.preset(exp_type)
    cli.float32_matmuls(cfg, torch.device(device))
    assert torch.backends.cuda.matmul.allow_tf32 is not off
    assert torch.backends.cudnn.allow_tf32 is not off
    assert ("TF32 off" in capsys.readouterr().out) is off
