"""The port's per-call constants, built once on their device
(`core/constants.py:cached`).

On the CPU:
- each cached constant has the bits of the expression it replaced, for
  every degree range and dtype the port uses, and `linspace` at the
  sample counts of every preset (both neo360 presets among them);
- a second lookup is a hit that returns the same tensor; another dtype
  or device is another entry, and so are other parameters;
- a constant first built under `torch.inference_mode()` serves an
  autograd forward and backward through `pos_enc` afterwards;
- an item of the span recorder counts the builds and hits while it was
  open.
On the card (`cuda`): one neo360 render tile and one per-step training
step, after a first of each, run under
`torch.cuda.set_sync_debug_mode("error")` and build no constant.
"""

import math
import os
import sys
import threading

import numpy as np
import pytest
import torch

from neo360_tpu_torch.core import constants, encoding, geometry, mip, \
    sampling
from neo360_tpu_torch.models.mipnerf360 import MipNeRF360MLP
from neo360_tpu_torch.models.neo360 import NeRFTP
from neo360_tpu_torch.models.pixelnerf import PixelNeRF
from neo360_tpu_torch.models.vanilla import VanillaNeRF
from neo360_tpu_torch.nn.resnet import latent_scaling
from neo360_tpu_torch.nn.triplane import GridEncoder
from neo360_tpu_torch.ops import interpolate
from neo360_tpu_torch.train import profiling

DTYPES = [torch.float32, torch.bfloat16]
# every (min_deg, max_deg) that a model passes to pos_enc or
# integrated_pos_enc
DEGREES = sorted({(m.min_deg_point, m.max_deg_point) for m in
                  (NeRFTP, PixelNeRF, VanillaNeRF, MipNeRF360MLP)}
                 | {(0, m.deg_view) for m in
                    (NeRFTP, PixelNeRF, VanillaNeRF, MipNeRF360MLP)}
                 | {(0, 10)})                     # PropMLP's default
# the presets' sample counts (cli.build_model): neo360 128 + 256,
# neo360_fast 64 + 60, vanilla 64 + 128, pixelnerf 64 + 64, mipnerf360
# 64 + 32
SAMPLES = (32, 60, 64, 128, 256)


@pytest.fixture
def fresh(monkeypatch):
    """An empty cache and counters at zero for the test."""
    monkeypatch.setattr(constants, "_cache", {})
    monkeypatch.setattr(constants.cached, "builds", 0)
    monkeypatch.setattr(constants.cached, "hits", 0)
    return constants


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit pattern (tells -0.0 from 0.0 and NaNs apart)."""
    return t.contiguous().view({4: torch.int32, 2: torch.int16,
                                8: torch.int64}[t.element_size()])


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(_bits(a), _bits(b)))


def _entry(name, params, dtype=torch.float32, device="cpu"):
    return constants._cache[(name, params, dtype, torch.device(device))]


# the expressions each constant replaced, as they were written per call
def _old_scales(min_deg, max_deg, dtype):
    return torch.tensor([2.0 ** i for i in range(min_deg, max_deg)],
                        dtype=dtype)


def _old_linspace(start, stop, num, dtype):
    if num == 1:
        return torch.full((1,), start, dtype=dtype)
    d = num - 1
    step = torch.arange(d, dtype=dtype) / d
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=dtype)])


def _old_latent_scaling(latent_hw):
    h, w = latent_hw
    s = torch.tensor([w, h], dtype=torch.float32)
    return s / (s - 1.0) * 2.0


def _linspace_args():
    out = set()
    for n in SAMPLES:
        out |= {(0.0, 1.0, n + 1), (0.0, 1.0 - sampling._FLOAT_MIN_EPS, n),
                (0.0, 1.0 - sampling._FLOAT_MIN_EPS, n + 1),
                (0.0, 1.0 - mip.EPS, n),
                (1.0 / (2 * n), 1.0 - 1.0 / (2 * n) - mip.EPS, n),
                (0.0, 1.0 - (mip.EPS + (1.0 - mip.EPS) / n), n)}
    sx, sy, sz = GridEncoder.side_lengths
    for g in (8, 32, 40, 64):           # grid sides of the presets and tests
        out |= {(-sx, sx, g), (-sy, sy, g), (0.0, sz, g)}
    return sorted(out | {(0.5, 2.0, 1)})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("degrees", DEGREES)
def test_pos_enc_scales_have_the_old_bits(fresh, degrees, dtype):
    x = torch.randn(5, 3).to(dtype)
    got = encoding.pos_enc(x, *degrees)
    scales = _entry("pos_enc.scales", degrees, dtype)
    assert _same_bits(scales, _old_scales(*degrees, dtype))
    xb = (x[..., None, :] * _old_scales(*degrees, dtype)[:, None]).reshape(
        5, -1)
    want = torch.cat([x, torch.sin(torch.cat([xb, xb + 0.5 * math.pi],
                                             dim=-1))], dim=-1)
    assert _same_bits(got, want)
    # integrated_pos_enc takes the same entry
    encoding.integrated_pos_enc(x, x.abs(), *degrees)
    assert _entry("pos_enc.scales", degrees, dtype) is scales
    assert constants.cached.builds == 1 and constants.cached.hits == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_linspace_has_the_old_bits_at_every_preset_count(fresh, dtype):
    args = _linspace_args()
    for start, stop, num in args:
        got = geometry.linspace(start, stop, num, dtype)
        assert _same_bits(got, _old_linspace(start, stop, num, dtype)), \
            (start, stop, num)
        assert geometry.linspace(start, stop, num, dtype) is got
    assert constants.cached.builds == len(args)
    assert constants.cached.hits == len(args)


def test_uv_scales_have_the_old_bits(fresh):
    for hw in ((120, 160), (60, 80), (15, 20), (4, 4)):
        assert _same_bits(latent_scaling(hw), _old_latent_scaling(hw))
    # GridEncoder's lift and PixelNeRF's latents: latent_scaling / image
    # size; NeRFTP's local gather: the same as Python floats
    lat_hw, (w, h) = (120, 160), (320, 240)
    want = _old_latent_scaling(lat_hw) / torch.tensor(
        [w, h], dtype=torch.float32)
    got = constants.cached("lift_uv.scale", (lat_hw, w, h), torch.float32,
                           "cpu", lambda: latent_scaling(lat_hw, "cpu")
                           / torch.tensor([w, h], dtype=torch.float32))
    assert _same_bits(got, want)
    cam = torch.randn(3, 8, 3)
    focal, c = torch.full((3,), 300.0), torch.full((3, 2), 100.0)
    scale = tuple(want.tolist())
    uv = interpolate.local_uv(cam, focal, c, scale)
    assert _same_bits(_entry("local_uv.scale", scale),
                      torch.tensor(scale, dtype=torch.float32))
    raw = geometry.projection(cam, torch.stack([focal[0], -focal[0]])[None],
                              c[:1], 3)
    raw = torch.cat([raw[:, :4], raw[:, 4:]], dim=0)
    assert _same_bits(uv, raw * torch.tensor(scale, dtype=torch.float32)
                      - 1.0)
    # homography_uv's pixel scale
    geometry.homography_uv((6, 10), torch.randn(2, 3, 4),
                           torch.rand(2, 4) + 1.0)
    assert _same_bits(_entry("homography_uv.scale", (6, 10)),
                      torch.tensor([(10 - 1) / 2.0, (6 - 1) / 2.0]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_resize_matrices_have_the_old_bits(fresh, dtype):
    image = torch.randn(2, 7, 9, 3).to(dtype)
    out = interpolate.resize_bilinear_align_corners(image, (5, 12))
    for n_out, n_in in ((5, 7), (12, 9)):
        assert _same_bits(_entry("resize_matrix", (n_out, n_in), dtype),
                          torch.as_tensor(interpolate._interp_matrix(
                              n_out, n_in), dtype=dtype))
    mh = torch.as_tensor(interpolate._interp_matrix(5, 7), dtype=dtype)
    mw = torch.as_tensor(interpolate._interp_matrix(12, 9), dtype=dtype)
    want = torch.einsum("ow,...hwc->...hoc", mw,
                        torch.einsum("oh,...hwc->...owc", mh, image))
    assert _same_bits(out, want)


def test_a_second_lookup_is_a_hit_and_keys_tell_entries_apart(fresh):
    calls = []

    def build(dtype, device):
        calls.append((dtype, device))
        return torch.arange(3, dtype=dtype, device=device)

    def get(params=(1, 2), dtype=torch.float32, device="cpu"):
        return constants.cached("probe", params, dtype, device,
                                lambda: build(dtype, device))

    first = get()
    assert get() is first and get(device=torch.device("cpu")) is first
    assert get(device=None) is first            # None is the CPU
    assert calls == [(torch.float32, "cpu")]
    assert constants.cached.builds == 1 and constants.cached.hits == 3
    bf = get(dtype=torch.bfloat16)
    meta = get(device="meta")
    other = get(params=(1, 3))
    assert bf.dtype == torch.bfloat16 and meta.device.type == "meta"
    assert len({id(t) for t in (first, bf, meta, other)}) == 4
    assert constants.cached.builds == 4
    assert get(dtype=torch.bfloat16) is bf and get(device="meta") is meta
    assert profiling.constant_counts() == {"builds": 4, "hits": 5}
    assert not first.requires_grad


def test_threads_share_one_entry_and_lose_no_count(fresh):
    """More threads than cores looking up the same constants, switching
    often: one build an entry, one tensor, every lookup counted."""
    threads, rounds, keys = 2 * (os.cpu_count() or 1) + 2, 200, 4
    got = [[] for _ in range(threads)]

    def work(i):
        for r in range(rounds):
            k = r % keys
            got[i].append(constants.cached(
                "probe", k, torch.float32, "cpu",
                lambda k=k: torch.full((2,), float(k))))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(i,))
                for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    assert constants.cached.builds == keys
    assert constants.cached.hits == threads * rounds - keys
    for k in range(keys):
        assert len({id(g[r]) for g in got
                    for r in range(k, rounds, keys)}) == 1


def test_a_build_in_another_dtype_or_device_raises(fresh):
    with pytest.raises(ValueError, match="keyed"):
        constants.cached("bad", (), torch.float32, "cpu",
                         lambda: torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="keyed"):
        constants.cached("bad", (), torch.float32, "cpu",
                         lambda: torch.zeros(2, device="meta"))
    assert constants._cache == {}


def test_built_under_inference_mode_serves_autograd(fresh):
    x = torch.randn(4, 3)
    with torch.inference_mode():
        rendered = encoding.pos_enc(x, 0, 4)
        t = geometry.linspace(0.0, 1.0, 9)
    scales = _entry("pos_enc.scales", (0, 4))
    assert not scales.is_inference() and not t.is_inference()
    assert not scales.requires_grad
    xg = x.clone().requires_grad_(True)
    out = encoding.pos_enc(xg, 0, 4)        # x * scales saves the scales
    (out * torch.linspace(0.5, 1.5, out.shape[-1])).sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
    assert _same_bits(out.detach(), rendered)
    assert constants.cached.builds == 2 and constants.cached.hits == 1


def test_an_item_counts_the_constants_built_and_served(fresh):
    profiling.clear()
    x = torch.randn(4, 3)
    with profiling.item("train.step"):
        encoding.pos_enc(x, 0, 10)
        encoding.pos_enc(x, 0, 10)
        geometry.linspace(0.0, 1.0, 5)
    with profiling.item("train.step"):
        encoding.pos_enc(x, 0, 10)
    got = profiling.items()
    assert [it["constants"] for it in got] == [{"builds": 2, "hits": 1},
                                               {"builds": 0, "hits": 1}]
    assert set(got[0]["spans"]) == {"train.step"}
    profiling.clear()


# --------------------------------------------------------------- the card

def _small_neo360(torch_dev):
    from neo360_tpu_torch import cli
    from neo360_tpu_torch.config import preset
    cfg = preset("neo360", seed=0, grid_size=(8, 8, 40), encoder_width=64,
                 num_coarse_samples=8, num_fine_samples=6, img_wh=(40, 30),
                 ray_batch_size=32)
    cli.float32_matmuls(cfg, torch_dev)
    return cfg, cli.build_model(cfg, torch_dev)


def _batch(cfg, dev):
    from neo360_tpu_torch import cli
    from neo360_tpu_torch.data.fixtures import MemoryScenes
    batch = MemoryScenes(2, cfg.img_wh, 3, split="train",
                         ray_batch_size=cfg.ray_batch_size
                         ).sample_train(np.random.default_rng(0))
    return {k: torch.as_tensor(batch[k], device=dev) for k in cli.STEP_KEYS}


def _without_syncs(fn):
    """fn() under sync debug mode "error": raises on any synchronising
    CUDA call; returns fn's result and the constants it built."""
    before = constants.cached.builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, constants.cached.builds - before


@pytest.mark.cuda
def test_a_render_tile_and_a_train_step_never_wait_for_the_stream():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from neo360_tpu_torch import cli
    from neo360_tpu_torch.models.neo360 import RAY_KEYS, SRC_KEYS
    from neo360_tpu_torch.train import loop
    dev = torch.device("cuda")
    cfg, model = _small_neo360(dev)
    batch = _batch(cfg, dev)
    src = {k: batch[k] for k in SRC_KEYS}

    # one tile of a view, with the scene encoded beforehand
    model.eval()
    with torch.inference_mode():
        enc = model.encode(*(src[k] for k in SRC_KEYS), False)

    def chunk(pack, rays):
        out = model(dict(rays, **src), pack, cfg.white_back,
                    out_depth=True)[1]
        return {"rgb": out["rgb"], "depth": out["depth"]}

    render = loop.make_image_renderer(chunk, cfg.chunk)
    rays = {k: batch[k][:1].expand(cfg.chunk, 3).contiguous()
            for k in RAY_KEYS}
    first = render(enc, rays)
    again, built = _without_syncs(lambda: render(enc, rays))
    assert built == 0
    assert torch.equal(first["rgb"], again["rgb"])

    # one per-step training step with its optimizer
    model.train()
    state = loop.create_train_state(
        model, lambda params: cli.build_optimizer(cfg, params))
    step = loop.make_train_step(cli.make_loss_fn(cfg, model),
                                with_model_state=True)
    gen = torch.Generator(dev).manual_seed(0)
    step(state, batch, gen)
    metrics, built = _without_syncs(lambda: step(state, batch, gen))
    assert built == 0
    assert torch.isfinite(metrics["loss"]).item()
