"""PixelNeRF as published (`PixelNeRF(network="resnet")`, the CLI's
`pixelnerf` preset with `mlp_type` "resnet") on the CPU, at small widths
with seeded weights, against plain versions written here from pixel-nerf's
code (src/model/resnetfc.py, code.py, src/render/nerf.py):

- `ResnetFC`: outputs and every parameter's gradient against a loop over
  its layers, with 3 views and with 1;
- `pos_enc_interleaved` and the three samplers, drawing from generators
  seeded alike;
- a batch of SB scenes against SB one-scene calls, for both networks;
- the default `preset("pixelnerf")` builds the state_dict of the JAX
  mirror as it was (the digest of its names and shapes), and the
  published keys build two 5 x 512 ResnetFCs;
- the NERDS360AE sampler's scene batch, and the CLI training the
  published network for 2 steps on fixture scenes;
- the model's spans in one training step.

Tolerances:
- `ResnetFC`: 1e-5 relative plus 1e-6 absolute on outputs and
  gradients: both sides run the same float32 matmuls; the plain loop
  averages the views with `mean` over a stacked axis, the module with a
  reshape, which sums in the same order (measured: equal bits).
- the encoding and samplers: equal bits (the same expressions).
- the scene batch: 1e-5 relative plus 1e-5 absolute: the batched call
  runs each matmul over SB times the rows, which the CPU's GEMM blocks
  differently (measured: at most 1.2e-6 absolute).
"""

import functools
import hashlib
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neo360_tpu_torch import cli
from neo360_tpu_torch.config import preset
from neo360_tpu_torch.core import encoding, sampling
from neo360_tpu_torch.data.fixtures import make_multi_scene_root
from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE
from neo360_tpu_torch.models import pixelnerf
from neo360_tpu_torch.models.pixelnerf import PixelNeRF
from neo360_tpu_torch.nn.resnetfc import ResnetFC
from neo360_tpu_torch.train import loop, profiling

torch.set_num_threads(1)

WH = (40, 30)
TINY = dict(num_coarse_samples=8, num_fine_samples=8)
# the default preset's state_dict names and shapes, as before the
# published network was added: 181 entries
DEFAULT_DIGEST = ("a507f9f187f11c56bd8c1e1327820950"
                  "fc6161dff79c269b13302074fa7b7684")


@pytest.fixture
def narrow(monkeypatch):
    """`cli.build_model`'s published network at 5 x 32, with 4 of its 8
    fine samples around the coarse depth."""
    monkeypatch.setattr(pixelnerf, "PixelNeRF", type("Narrow", (PixelNeRF,), {
        "__init__": functools.partialmethod(
            PixelNeRF.__init__, d_hidden=32, num_fine_depth_samples=4)}))


def _close(a, b, rtol=1e-5, atol=1e-6):
    return torch.allclose(a, b, rtol=rtol, atol=atol)


def _seeded(module, seed=0):
    """Every parameter N(0, 1/fan_in)-ish from a seed, biases small and
    fc_1 nonzero (the published zero init would hide the blocks)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            fan = p.shape[-1] if p.dim() > 1 else 100
            p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan))
    return module


def _plain_resnetfc(net, x, z, nv):
    """pixel-nerf's ResnetFC.forward on inputs (NV*B, d) with its own
    combine_interleaved: reshape (NV, B, d) and mean over views."""
    lin = lambda m, v: F.linear(v, m.weight, m.bias)
    x = lin(net.lin_in, x)
    for i in range(net.n_blocks):
        if i == net.combine_layer and nv > 1:
            x = x.reshape(nv, -1, x.shape[-1]).mean(0)
        if i < net.combine_layer:
            x = x + lin(net.lin_z[i], z)
        blk = net.blocks[i]
        x = x + lin(blk.fc_1, F.relu(lin(blk.fc_0, F.relu(x))))
    return lin(net.lin_out, F.relu(x))


@pytest.mark.parametrize("nv", [3, 1])
def test_resnetfc_against_a_plain_loop(nv):
    net = _seeded(ResnetFC(10, 12, 4, n_blocks=5, d_hidden=16,
                           combine_layer=3))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(nv * 7, 10, generator=gen)
    z = torch.randn(nv * 7, 12, generator=gen)
    out = net(x, z, nv)
    want = _plain_resnetfc(net, x, z, nv)
    assert out.shape == (7, 4) and _close(out, want)
    params = list(net.parameters())
    cot = torch.randn(7, 4, generator=gen)
    got = torch.autograd.grad((out * cot).sum(), params)
    ref = torch.autograd.grad((want * cot).sum(), params)
    for (name, _), a, b in zip(net.named_parameters(), got, ref):
        assert _close(a, b), name
    assert len(net.lin_z) == 3


def test_resnetfc_starts_each_block_as_the_identity():
    net = ResnetFC(10, 12, n_blocks=2, d_hidden=8,
                   generator=torch.Generator().manual_seed(0))
    for blk in net.blocks:
        assert not blk.fc_1.weight.any() and not blk.fc_1.bias.any()
        x = torch.randn(3, 8)
        assert torch.equal(blk(x), x)


def test_the_published_encoding():
    """[x, sin(f0 x), cos(f0 x), ...], f_i = 1.5 * 2^i, as pixel-nerf's
    PositionalEncoding (repeat, addcmul, sin, view) computes it."""
    x = torch.randn(50, 3, generator=torch.Generator().manual_seed(2))
    freqs = 1.5 * 2.0 ** torch.arange(0, 6)
    freqs = torch.repeat_interleave(freqs, 2).view(1, -1, 1)
    phases = torch.zeros(12)
    phases[1::2] = np.pi * 0.5
    embed = x.unsqueeze(1).repeat(1, 12, 1)
    embed = torch.sin(torch.addcmul(phases.view(1, -1, 1), embed, freqs))
    want = torch.cat([x, embed.view(50, -1)], -1)
    got = encoding.pos_enc_interleaved(x, 6, 1.5)
    assert got.shape == (50, 39) and torch.equal(got, want)


def _gen(seed=5):
    return torch.Generator().manual_seed(seed)


def test_the_published_samplers_draw_as_pixel_nerf():
    """sample_coarse, sample_fine and sample_fine_depth of pixel-nerf's
    renderer, written out here, with the same generator."""
    near, far, b, kc = 0.02, 3.0, 6, 8
    g = _gen()
    step = 1.0 / kc
    z = torch.linspace(0, 1 - step, kc).unsqueeze(0).repeat(b, 1)
    z = z + torch.rand(z.shape, generator=g) * step
    want = near * (1 - z) + far * z
    got = sampling.sample_bins(b, kc, near, far, True, torch.zeros(1),
                               _gen())
    assert torch.equal(got, want)

    weights = torch.rand(b, kc, generator=_gen(6))
    g = _gen()
    w = weights + 1e-5
    pdf = w / torch.sum(w, -1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)],
                    -1)
    u = torch.rand(b, 4, generator=g)
    inds = torch.clamp_min(torch.searchsorted(cdf, u, right=True).float()
                           - 1.0, 0.0)
    z = (inds + torch.rand(inds.shape, generator=g)) / kc
    want = near * (1 - z) + far * z
    got = sampling.sample_bins_pdf(weights, 4, near, far, True, _gen())
    assert torch.equal(got, want)

    depth = torch.tensor([0.01, 1.0, 2.0, 2.999, 1.5, 0.5])
    g = _gen()
    z = depth.unsqueeze(1).repeat((1, 4))
    z = z + torch.randn(z.shape, generator=g) * 0.5
    want = torch.max(torch.min(z, torch.full_like(z, far)),
                     torch.full_like(z, near))
    got = sampling.sample_near_depth(depth, 4, 0.5, near, far, True, _gen())
    assert torch.equal(got, want)
    assert (want == near).any() and (want == far).any()


def test_a_rank_draws_its_rows_of_the_batch_normals():
    """The depth samples' normals under data parallelism: a RowDraws
    draws the global batch's and keeps its block of rays, as for the
    uniforms."""
    depth = torch.linspace(0.5, 2.5, 6)
    whole = sampling.sample_near_depth(depth, 4, 0.1, 0.0, 3.0, True, _gen())
    for rank in range(2):
        part = sampling.sample_near_depth(
            depth[3 * rank:3 * rank + 3], 4, 0.1, 0.0, 3.0, True,
            sampling.RowDraws(_gen(), rank, 2))
        assert torch.equal(part, whole[3 * rank:3 * rank + 3])


def test_the_deterministic_samplers_take_the_midpoints():
    got = sampling.sample_bins(3, 4, 0.0, 1.0, False, torch.zeros(1))
    assert torch.equal(got, torch.tensor([[0.125, 0.375, 0.625, 0.875]] * 3))
    one_bin = torch.tensor([[0.0, 1.0, 0.0, 0.0]])
    got = sampling.sample_bins_pdf(one_bin, 2, 0.0, 1.0, False)
    assert torch.allclose(got, torch.tensor([[0.375, 0.375]]))
    depth = torch.tensor([0.5])
    assert torch.equal(sampling.sample_near_depth(depth, 3, 0.1, 0.0, 1.0,
                                                  False), depth.repeat(1, 3))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_multi_scene_root(str(tmp_path_factory.mktemp("scenes")), 3,
                                 wh=WH)


@pytest.fixture(scope="module")
def batch(root):
    """Two scenes' source stacks and 6 rays of each."""
    ds = NeRDS360AE(root, "train", WH, 3, 12)
    s = ds.sample_train_scenes(np.random.default_rng(3), 2)
    return {k: torch.as_tensor(np.asarray(v)) for k, v in s.items()}


def test_the_sampler_draws_a_batch_of_scenes(batch, root):
    assert batch["src_imgs"].shape == (2, 3, WH[1], WH[0], 3)
    assert batch["src_poses"].shape == (2, 3, 4, 4)
    assert batch["src_focal"].shape == (2, 3)
    assert batch["src_c"].shape == (2, 3, 2)
    for k in ("rays_o", "rays_d", "viewdirs", "target"):
        assert batch[k].shape == (2, 6, 3), k
    # two distinct scenes
    assert not torch.equal(batch["src_imgs"][0], batch["src_imgs"][1])
    ds = NeRDS360AE(root, "train", WH, 3, 12)
    with pytest.raises(ValueError):
        ds.sample_train_scenes(np.random.default_rng(3), 1)


def _model(network, seed):
    if network == "resnet":
        cfg = preset("pixelnerf", device="cpu", mlp_type="resnet", **TINY)
    else:
        cfg = preset("pixelnerf", device="cpu", num_coarse_samples=8,
                     num_fine_samples=8)
    model = cli.build_model(cfg.replace(seed=seed), "cpu")
    for level, mlp in enumerate((model.coarse_mlp, model.fine_mlp)):
        _seeded(mlp, seed + level)     # live blocks (fc_1 starts at zero)
    return model


@pytest.mark.parametrize("network", ["nerf", "resnet"])
def test_a_batch_of_scenes_equals_one_call_a_scene(network, batch, narrow):
    """One call over 2 scenes (one encode of 6 images, one gather) and
    two one-scene calls give the same levels, scene by scene; BatchNorm on
    its running statistics, so the images are encoded independently, and
    deterministic sampling, so no draw depends on the batch."""
    model = _model(network, seed=3).eval()
    keys = cli.RAY_KEYS + cli.SRC_KEYS
    with torch.no_grad():
        both = model({k: batch[k] for k in keys},
                     model.encode(batch["src_imgs"], False))
        for s in range(2):
            one = model({k: batch[k][s] for k in keys},
                        model.encode(batch["src_imgs"][s], False))
            for level in range(2):
                for k in ("rgb", "acc", "depth", "weights", "t_vals"):
                    a, b = both[level][k][s], one[level][k]
                    assert a.shape == b.shape, (level, k)
                    assert _close(a, b, 1e-5, 1e-5), (network, s, level, k)
    assert both[1]["rgb"].shape == (2, 6, 3)
    for level in both:                  # neither level's density is dead
        assert 0 < level["acc"].max() <= 1 + 1e-6


def test_the_default_preset_is_the_jax_mirror_as_it_was():
    model = cli.build_model(preset("pixelnerf", device="cpu"), "cpu")
    sd = model.state_dict()
    text = ";".join(f"{k}:{tuple(v.shape)}" for k, v in sd.items())
    assert len(sd) == 181
    assert hashlib.sha256(text.encode()).hexdigest() == DEFAULT_DIGEST
    assert model.network == "nerf" and model.padding == "zeros"


def test_the_published_keys_build_the_published_network():
    cfg = preset("pixelnerf", device="cpu", mlp_type="resnet")
    assert (cfg.ray_batch_size, cfg.scenes_per_step) == (512, 4)
    assert cfg.lr_init == cfg.lr_final == 1e-4 and cfg.lr_delay_steps == 0
    model = cli.build_model(cfg, "cpu")
    assert (model.num_coarse_samples, model.num_fine_samples,
            model.num_fine_depth_samples) == (64, 32, 16)
    assert model.padding == "border" and pixelnerf.DEPTH_STD == 0.01
    assert (pixelnerf.PE_FREQS, pixelnerf.PE_FREQ_FACTOR) == (6, 1.5)
    for mlp in (model.coarse_mlp, model.fine_mlp):
        assert isinstance(mlp, ResnetFC)
        assert (mlp.n_blocks, mlp.combine_layer, len(mlp.lin_z)) == (5, 3, 3)
        assert tuple(mlp.lin_in.weight.shape) == (512, 42)
        assert tuple(mlp.lin_z[0].weight.shape) == (512, 512)
        assert tuple(mlp.lin_out.weight.shape) == (4, 512)
        assert tuple(mlp.blocks[4].fc_1.weight.shape) == (512, 512)
    with pytest.raises(ValueError):
        PixelNeRF(network="mlp")


def test_a_training_step_records_each_level_once(batch, narrow):
    """One per-step training step of 2 scenes: `model.encode` once and
    `model.sample`, `.gather`, `.mlp` and `.composite` once a level, all
    inside `train.loss` of one `train.step` item."""
    cfg = preset("pixelnerf", device="cpu", mlp_type="resnet",
                 ray_batch_size=12, scenes_per_step=2, **TINY)
    model = cli.build_model(cfg, "cpu").train()
    state = loop.create_train_state(
        model, lambda params: cli.build_optimizer(cfg, params))
    step = loop.make_train_step(cli.make_loss_fn(cfg, model),
                                with_model_state=True)
    profiling.clear()
    metrics = step(state, batch, _gen())
    assert math.isfinite(float(metrics["loss"]))
    got = profiling.items()
    assert [it["name"] for it in got] == ["train.step"]
    table = got[0]["spans"]
    assert table["model.encode"]["count"] == 1
    for p in ("model.sample", "model.gather", "model.mlp",
              "model.composite"):
        assert table[p]["count"] == 2, p
    loss = table["train.loss"]
    children = sum(table[p]["host_ms"] for p in
                   ("model.encode", "model.sample", "model.gather",
                    "model.mlp", "model.composite"))
    assert loss["host_ms"] - loss["self_host_ms"] == \
        pytest.approx(children, rel=1e-9, abs=1e-9)


def test_the_cli_trains_the_published_network(root, tmp_path, monkeypatch,
                                              narrow):
    """`--mlp_type resnet` through `main`, narrowed (2 scenes a step in
    place of the preset's 4): 2 steps, a checkpoint, finite metrics."""
    parse = cli.parse_args
    monkeypatch.setattr(cli, "parse_args", lambda argv: parse(argv).replace(
        scenes_per_step=2, **TINY))
    cli.main(["--exp_type", "pixelnerf", "--mlp_type", "resnet",
              "--ray_batch_size", "8",
              "--root_dir", root, "--img_wh", *map(str, WH),
              "--ckpt_dir", str(tmp_path), "--exp_name", "pub",
              "--run_max_steps", "2", "--save_every_steps", "2",
              "--device", "cpu"])
    exp = tmp_path / "pub"
    assert os.listdir(exp / "checkpoints")
    lines = (exp / "metrics.jsonl").read_text().splitlines()
    assert lines and "val_psnr" in "".join(lines)


@pytest.mark.cuda
def test_a_step_on_the_card_runs_a_and_d_once_a_level(batch, narrow,
                                                      monkeypatch):
    """On the card a step of 2 scenes samples each level's latent with one
    launch of kernel A (border mode, the 6-image table) and composites it
    with one of D, and its backward launches A' and D' once a level; the
    deterministic forward, TF32 off, agrees with the CPU's plain path (the
    latent sampled with a bmm fold there, the composite in plain PyTorch,
    the convolutions and matmuls summed in other orders: 1e-5 relative
    plus 1e-5 absolute)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from neo360_tpu_torch.ops import kernels
    card = torch.device("cuda")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    model = _model("resnet", seed=3).eval()
    keys = cli.RAY_KEYS + cli.SRC_KEYS
    with torch.no_grad():
        want = model({k: batch[k] for k in keys},
                     model.encode(batch["src_imgs"], False))
    model = model.to(card)
    on = {k: batch[k].to(card) for k in cli.STEP_KEYS}
    names = ("table_sample_fwd", "table_sample_bwd",
             "composite_vanilla_fwd", "composite_vanilla_bwd")
    before = {k: kernels.launches[k] for k in names}
    with torch.no_grad():
        got = model({k: on[k] for k in keys},
                    model.encode(on["src_imgs"], False))
    for level in range(2):
        for k in ("rgb", "weights", "depth"):
            assert torch.allclose(got[level][k].cpu(), want[level][k],
                                  rtol=1e-5, atol=1e-5), (level, k)
    cfg = preset("pixelnerf", device="cuda", mlp_type="resnet",
                 ray_batch_size=12, scenes_per_step=2, **TINY)
    loss, _ = cli.make_loss_fn(cfg, model.train())(on, torch.Generator(
        card).manual_seed(1))
    loss.backward()
    torch.cuda.synchronize()
    assert {k: kernels.launches[k] - before[k] for k in names} == {
        "table_sample_fwd": 4, "table_sample_bwd": 2,
        "composite_vanilla_fwd": 4, "composite_vanilla_bwd": 2}
