"""Two data-parallel ranks against one rank, through the port's CLI, on
the CPU at a tiny size (40x30 fixture scenes written by the port's own
writer; the cut-down widths of tests/test_torch_cli_baselines.py, 16 rays
a step, tri-planes shrunk to 30x40): the ray-buffer trainer (vanilla),
MipNeRF-360's ray-buffer trainer (the sqrt of the batch MSE averaged over
the ranks; MLPs 8 x 32 and 2 x 32, 8 + 8 + 4 samples, as
tests/test_torch_cli_mipnerf360.py), the per-step trainer (neo360), the
scene-mixed stage trainer (neo360_fast, K=2, S=2), the optimize mode
(cached latents) and the LPIPS finetune (random LPIPS weights, one 30x30
patch gathered from the ranks), then `run_eval` full_eval, and `main`'s
two entries: its spawn of two ranks, and two processes that join the
group a torchrun environment describes.

The two ranks run in two gloo processes started by the port's launcher
(`sharding.launch`, a file store under tmp_path); each rank writes under
its own ckpt_dir, so a file under rank 1's is a file rank 1 wrote.

Tolerances: every parameter and buffer after training 1e-6 relative plus
1e-6 absolute against one rank (the ranks average their rows' gradients,
which sums the batch in another order; after one Adam step the next
step's BatchNorm variances, values up to 1.7, land ~1e-6 apart), and
bit-equal between the two ranks; eval
depth and PSNR / SSIM 1e-6 (each tile is rendered by one rank as one
rank renders it).
"""

import functools
import json
import os
import socket

import numpy as np
import pytest
import torch

from neo360_tpu_torch import cli
from neo360_tpu_torch.data.fixtures import make_micro_scene
from neo360_tpu_torch.models import mipnerf360
from neo360_tpu_torch.nn.lpips import random_torch_state
from neo360_tpu_torch.nn.triplane import GridEncoder
from neo360_tpu_torch.parallel import sharding

torch.set_num_threads(1)

TINY = {"vanilla": dict(num_coarse_samples=8, num_fine_samples=8,
                        steps_per_call=1),
        "mipnerf360": dict(num_prop_samples=8, num_fine_samples=4,
                           steps_per_call=1),
        "neo360": dict(grid_size=(8, 8, 8), encoder_width=64,
                       num_coarse_samples=8, num_fine_samples=6),
        "neo360_fast": dict(bf16=False, grid_size=(8, 8, 4),
                            encoder_width=64, lift_dim=32,
                            num_prop_samples=8, num_fine_samples=6)}
TRAIN = ("vanilla", "mipnerf360", "neo360", "stage", "optimize",
         "finetune")
MIP_WIDTHS = dict(nerf_netwidth=32, prop_netdepth=2, prop_netwidth=32)


def _argv(exp_type, root, *extra):
    return ["--exp_type", exp_type, "--root_dir", root, "--img_wh", "40",
            "30", "--device", "cpu", *extra]


def _cases(scene, root, lpips):
    steps = ["--run_max_steps", "2", "--save_every_steps", "2"]
    return {
        "vanilla": _argv("vanilla", scene, "--batch_size", "64", *steps),
        "mipnerf360": _argv("mipnerf360", scene, "--batch_size", "64",
                            *steps),
        "neo360": _argv("neo360", root, "--ray_batch_size", "16", *steps),
        "stage": _argv("neo360_fast", root, "--ray_batch_size", "16",
                       "--stage_k", "2", *steps),
        "optimize": _argv("neo360_fast", root, "--ray_batch_size", "16",
                          "--is_optimize", *steps),
        "finetune": _argv("neo360_fast", root, "--finetune_lpips",
                          "--lpips_weights", lpips, "--run_max_steps", "1",
                          "--save_every_steps", "1"),
    }


def _files(path):
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, fs in os.walk(path) for f in fs)


def _run_cases(base, cases, eval_argv=None):
    """Train every case (and evaluate with `eval_argv`) under
    <base>/rank<r>, or <base>/one outside a group; each case's parameters
    and buffers, the eval summary and the files this process wrote."""
    group = sharding.current()
    out_dir = os.path.join(base, "one" if group is None
                           else f"rank{group.rank}")
    hw, mip = GridEncoder.plane_hw, mipnerf360.MipNeRF360
    GridEncoder.plane_hw = (30, 40)

    class TinyMip(mip):
        __init__ = functools.partialmethod(mip.__init__, **MIP_WIDTHS)

    mipnerf360.MipNeRF360 = TinyMip
    out = {}
    try:
        for name, argv in cases.items():
            cfg = cli.parse_args(argv)
            cfg = cfg.replace(ckpt_dir=os.path.join(out_dir, name),
                              **TINY[cfg.exp_type])
            state = cli.run_train(cfg)
            out[name] = {k: v.detach().clone()
                         for k, v in state.model.state_dict().items()}
        if eval_argv is not None:
            cfg = cli.parse_args(eval_argv)
            cfg = cfg.replace(ckpt_dir=os.path.join(out_dir, "eval"),
                              **TINY[cfg.exp_type])
            out["eval"] = cli.run_eval(cfg)
    finally:
        GridEncoder.plane_hw, mipnerf360.MipNeRF360 = hw, mip
    out["files"] = _files(out_dir)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One rank in this process, then two ranks in two processes."""
    base = tmp_path_factory.mktemp("dp")
    scene = make_micro_scene(str(base / "scene"), n_val=2, wh=(40, 30))
    root = base / "scenes"
    for s in range(2):
        make_micro_scene(str(root / f"scene_{s:03d}"), n_val=1,
                         wh=(40, 30), seed=100 + s)
    lpips = str(base / "lpips.pt")
    torch.save(random_torch_state(3), lpips)
    cases = _cases(scene, str(root), lpips)
    one = _run_cases(str(base), cases)
    ckpt = str(base / "one" / "stage" / "exp" / "checkpoints" /
               "ckpt_00000002.pt")
    eval_argv = cases["stage"] + ["--eval_mode", "full_eval",
                                  "--ckpt_path", ckpt]
    one.update(_run_cases(str(base), {}, eval_argv))
    ranks = sharding.launch(_run_cases, 2, str(base), cases, eval_argv,
                            device="cpu",
                            init_method=f"file://{base}/store")
    return base, one, ranks


@pytest.mark.parametrize("case", TRAIN)
def test_two_ranks_train_as_one(runs, case):
    """Each trainer on two ranks gives the one-rank parameters and
    buffers (module docstring), the same bits on both ranks."""
    _, one, (r0, r1) = runs
    assert set(r0[case]) == set(one[case])
    for k, v in one[case].items():
        torch.testing.assert_close(r0[case][k], v, rtol=1e-6, atol=1e-6,
                                   msg=f"{case} {k}")
        assert torch.equal(r0[case][k], r1[case][k]), f"{case} {k}"


def test_two_ranks_evaluate_as_one(runs):
    """run_eval full_eval on two ranks (each view's tiles split between
    them, gathered) gives the one-rank metrics, images and raw depth, and
    only rank 0 writes them."""
    base, one, (r0, r1) = runs
    for k, v in one["eval"].items():
        assert abs(r0["eval"][k] - v) < 1e-6 and r0["eval"][k] == \
            r1["eval"][k], k
    ev0, ev1 = base / "rank0" / "eval", base / "one" / "eval"
    names = _files(ev1)
    assert any(n.endswith("depth_img000.jpg") for n in names)
    assert _files(ev0) == names
    with open(ev0 / "exp" / "results.json") as f, \
            open(ev1 / "exp" / "results.json") as g:
        ours, ref = json.load(f), json.load(g)
    np.testing.assert_allclose(ours["psnr"]["views"], ref["psnr"]["views"],
                               atol=1e-6)
    np.testing.assert_allclose(ours["ssim"]["views"], ref["ssim"]["views"],
                               atol=1e-6)
    for n in names:
        if n.endswith(".npz"):
            np.testing.assert_allclose(np.load(ev0 / n)["depth"],
                                       np.load(ev1 / n)["depth"], atol=1e-6)


def test_only_rank0_writes(runs):
    """Rank 0 writes what one rank writes (metrics, checkpoints, val
    grids, eval artifacts); rank 1 writes nothing."""
    _, one, (r0, r1) = runs
    assert r1["files"] == []
    assert r0["files"] == one["files"]
    assert any(f.endswith("ckpt_00000002.pt") for f in r0["files"])


def test_main_spawns_two_ranks(tmp_path, capsys):
    """`cli.main` with world_size=2 starts two ranks (33 rays a step,
    rounded to 34), says so and returns rank 0's step count; then its
    full_eval on two ranks returns the summary."""
    scene = make_micro_scene(str(tmp_path / "scene"), n_val=1, wh=(40, 30))
    argv = _argv("vanilla", scene, "--ckpt_dir", str(tmp_path / "ck"),
                 "--batch_size", "33", "--run_max_steps", "1",
                 "--save_every_steps", "1", "--chunk", "600")
    parse = cli.parse_args
    try:
        cli.parse_args = lambda a: parse(a).replace(**TINY["vanilla"])
        step = cli.main(argv, world_size=2)
        summary = cli.main(argv + ["--eval_mode", "full_eval"],
                           world_size=2)
    finally:
        cli.parse_args = parse
    out = capsys.readouterr().out
    assert step == 1
    assert out.count("data-parallel over 2 devices") == 2
    assert np.isfinite(summary["psnr"])
    exp = tmp_path / "ck" / "exp"
    assert os.path.exists(exp / "checkpoints" / "ckpt_00000001.pt")
    assert os.path.exists(exp / "results.json")


def _torchrun_rank(rank, port, argv, result):
    """One process of a two-process torchrun group on this host: the
    environment torchrun gives, then `cli.main`."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="2", GROUP_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    parse = cli.parse_args
    cli.parse_args = lambda a: parse(a).replace(**TINY["vanilla"])
    step = cli.main(argv)
    assert sharding.current() is None   # main left the group
    with open(f"{result}{rank}", "w") as f:
        f.write(str(step))


def test_main_joins_a_torchrun_group(tmp_path):
    """Under torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, ...,
    MASTER_ADDR / MASTER_PORT) `cli.main` joins that group instead of
    starting ranks: two such processes train vanilla for one step (33
    rays rounded to 34) and return the step count; rank 0 writes the
    checkpoint."""
    import torch.multiprocessing as mp
    scene = make_micro_scene(str(tmp_path / "scene"), n_val=1, wh=(40, 30))
    argv = _argv("vanilla", scene, "--ckpt_dir", str(tmp_path / "ck"),
                 "--batch_size", "33", "--run_max_steps", "1",
                 "--save_every_steps", "1", "--chunk", "600")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_torchrun_rank,
                         args=(r, port, argv, str(tmp_path / "step")))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=300)
    finally:
        for p in procs:
            if p.exitcode is None:
                p.terminate()
                p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    for r in range(2):
        assert (tmp_path / f"step{r}").read_text() == "1"
    exp = tmp_path / "ck" / "exp"
    assert os.path.exists(exp / "checkpoints" / "ckpt_00000001.pt")
