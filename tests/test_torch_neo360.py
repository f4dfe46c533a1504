"""Parity of the port's encoder and NeO-360 model with the JAX package, on
the same weights (converted through weights.from_flax_flat) and the same
fixture scene, at a tiny size: grid (8, 8, 4), encoder width 64, lift 32,
8 proposal and 6 fine samples, float32.

Tolerance: 1e-4 absolute (plus 1e-4 relative) — the convolutions and
matmuls sum in a different order in the two frameworks, which moves the
float32 encoder outputs by a few 1e-5 at magnitudes ~4.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neo360_tpu.models.neo360 import NeRFTP as JNeRFTP
from neo360_tpu.nn.resnet import SpatialEncoder as JSpatialEncoder
from neo360_tpu_torch import cli, weights
from neo360_tpu_torch.config import preset
from neo360_tpu_torch.models.neo360 import NeRFTPMLP
from neo360_tpu_torch.train.loop import make_image_renderer

torch.set_num_threads(1)

ATOL = RTOL = 1e-4
TINY = dict(grid_size=(8, 8, 4), encoder_width=64, lift_dim=32,
            num_prop_samples=8, num_fine_samples=6)
SRC = ("src_imgs", "src_poses", "src_focal", "src_c")
RAYS = ("rays_o", "rays_d", "viewdirs")


def _close(ours, ref):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def _perturb_stats(variables, seed=0):
    """Random running statistics, so "running" mode is a real test."""
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(variables, sep="/")
    for k, v in flat.items():
        if k.startswith("batch_stats/"):
            shape = np.shape(v)
            flat[k] = jnp.asarray(
                rng.uniform(0.5, 2.0, shape) if k.endswith("var")
                else rng.normal(scale=0.3, size=shape), jnp.float32)
    return flax.traverse_util.unflatten_dict(flat, sep="/")


def _port_weights(variables):
    return weights.from_flax_flat(
        flax.traverse_util.flatten_dict(variables, sep="/"))


@pytest.fixture(scope="module")
def sample(multi_scene_root):
    from neo360_tpu.data.nerds360_ae import NeRDS360AE
    ds = NeRDS360AE(multi_scene_root, "test", (40, 30), 3)
    return ds.sample_test(0, 1)


@pytest.fixture(scope="module")
def jax_model(sample):
    model = JNeRFTP(num_src_views=3, use_proposal=True,
                    remat_encoder=False, **TINY)
    rays = {k: jnp.asarray(sample[k][:4] if k in RAYS else sample[k])
            for k in RAYS + SRC}
    variables = jax.jit(lambda r: model.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        r, True, False))(rays)
    return model, _perturb_stats(variables)


@pytest.fixture(scope="module")
def port_model(jax_model):
    cfg = preset("neo360_fast", bf16=False, **TINY)
    model = cli.build_model(cfg, "cpu")
    weights.load_into(model, _port_weights(jax_model[1]))
    return model


def _sub(variables, *path):
    """The variables of one submodule of the model."""
    out = {}
    for coll, tree in variables.items():
        for p in path:
            tree = tree[p]
        out[coll] = tree
    return out


def _apply(module, variables, batch_stats, *args, **kw):
    """module.apply, jitted (eager Flax dispatch is ~10x slower on CPU);
    batch-stats BatchNorm mutates and discards the running statistics."""
    def fn(v, *a):
        if batch_stats:
            return module.apply(v, *a, True, mutable=["batch_stats"],
                                **kw)[0]
        return module.apply(v, *a, False, **kw)
    return jax.jit(fn)(variables, *args)


@pytest.mark.parametrize("batch_stats", [True, False])
def test_spatial_encoder_matches_jax(sample, jax_model, port_model,
                                     batch_stats):
    imgs = sample["src_imgs"]
    v = _sub(jax_model[1], "encoder", "spatial_encoder")
    ref = _apply(JSpatialEncoder(), v, batch_stats, jnp.asarray(imgs))
    with torch.no_grad():
        ours = port_model.encoder.spatial_encoder(torch.as_tensor(imgs),
                                                  batch_stats)
    assert ours.shape == (3, 15, 20, 512)
    _close(ours, ref)


@pytest.mark.parametrize("bn_mode", ["batch", "running"])
def test_encode_matches_jax(sample, jax_model, port_model, bn_mode):
    """NeRFTP.encode: the GridEncoder as a whole (grid lift, depth_fc,
    tri-pillar logits, the softmax pillar collapse, floorplan convs) in
    the plane tables, and the projected pixel latent in the local table."""
    model, v = jax_model
    jpt, jlt, _ = _apply(model, v, bn_mode == "batch",
                         *(jnp.asarray(sample[k]) for k in SRC),
                         method=JNeRFTP.encode)
    with torch.no_grad():
        pt, lt, (plane_hw, latent_hw) = port_model.encode(
            *(torch.as_tensor(sample[k]) for k in SRC), bn_mode == "batch")
    assert plane_hw == (120, 160) and latent_hw == (15, 20)
    for a, b in zip(pt, jpt):
        _close(a, b)
    _close(lt, jlt["f"])


def test_forward_matches_jax(sample, jax_model, port_model):
    """NeRFTP.__call__ on the proposal path, randomized=False, with depth:
    both levels' composites, weights and resampled t_vals."""
    model, v = jax_model
    rays = {k: jnp.asarray(sample[k][:24] if k in RAYS else sample[k])
            for k in RAYS + SRC}
    enc = _apply(model, v, True, *(rays[k] for k in SRC),
                 method=JNeRFTP.encode)
    ref = jax.jit(lambda v, r, e: model.apply(
        v, r, False, False, out_depth=True, encoded=e))(v, rays, enc)
    trays = {k: torch.tensor(np.asarray(a)) for k, a in rays.items()}
    with torch.no_grad():
        tenc = port_model.encode(*(trays[k] for k in SRC), True)
        out = port_model(trays, tenc, False, out_depth=True)
    assert len(out) == 2
    assert out[0]["fg_weights"].shape == (24, 9)
    assert out[1]["fg_weights"].shape == (24, 7)
    for level in range(2):
        for k in ("rgb", "fg_rgb", "bg_rgb", "fg_acc", "bg_acc", "bg_lambda",
                  "depth", "fg_depth", "fg_weights", "bg_weights",
                  "fg_tvals", "bg_tvals", "far"):
            _close(out[level][k], ref[level][k])


def test_tiled_renderer_pads_ragged_tail():
    """A ray count that is not a multiple of the tile: edge-padded tiles,
    outputs equal to one untiled call, padding stripped."""
    seen = []

    def chunk_fn(pack, rays):
        seen.append(rays["x"].shape[0])
        return {"y": rays["x"] * pack + 1.0}

    x = torch.arange(23, dtype=torch.float32)[:, None].repeat(1, 3)
    out = make_image_renderer(chunk_fn, chunk=8)(2.0, {"x": x})
    assert seen == [8, 8, 8]
    torch.testing.assert_close(out["y"], x * 2.0 + 1.0)


def test_tiled_render_fn_matches_untiled(sample, port_model, monkeypatch):
    """cli.make_render_fn over 1200 rays in 256-ray tiles equals one
    untiled forward of the same rays, and encodes once per scene_key."""
    cfg = preset("neo360_fast", bf16=False, chunk=256, **TINY)
    encodes = []
    encode = port_model.encode
    monkeypatch.setattr(port_model, "encode",
                        lambda *a: encodes.append(a) or encode(*a))
    render_fn = cli.make_render_fn(cfg, port_model, "cpu")
    out = render_fn(dict(sample, scene_key=0))
    few = {k: sample[k][:4] for k in RAYS}
    for key in (0, 0, 1, 1, None):
        render_fn(dict(sample, scene_key=key, **few))
    assert len(encodes) == 3        # keys 0, 1 and the keyless sample
    assert out["rgb"].shape == (1200, 3) and out["depth"].shape == (1200,)
    trays = {k: torch.as_tensor(sample[k]) for k in RAYS + SRC}
    with torch.no_grad():
        enc = port_model.encode(*(trays[k] for k in SRC), True)
        ref = port_model(trays, enc, False, out_depth=True)[1]
    for k in ("rgb", "depth", "fg_acc"):
        torch.testing.assert_close(out[k], ref[k], atol=1e-5, rtol=1e-5)


def test_weights_reject_unused_and_missing(jax_model):
    flat = flax.traverse_util.flatten_dict(jax_model[1], sep="/")
    with pytest.raises(KeyError):
        weights.from_flax_flat({**flat, "params/encoder/extra/foo": 1.0})
    sd = weights.from_flax_flat(flat)
    model = cli.build_model(preset("neo360_fast", bf16=False, **TINY), "cpu")
    with pytest.raises(KeyError):
        weights.load_into(model, {**sd, "encoder.extra.weight":
                                  torch.zeros(1)})
    missing = dict(sd)
    missing.pop("fg_fine_mlp.rgb.bias")
    with pytest.raises(KeyError):
        weights.load_into(model, missing)


# NeRFTPMLP at the neo360 cells' widths: netwidth 128, condition width 64,
# fg inputs 63 + 128 + 128 = 319 and bg 84 + 128 + 128 = 340 wide
MLP_ROWS = dict(b=4, s=5)


def _concat_forward(mlp, x, viewdirs_enc, world_latent, local_latent,
                    num_views):
    """NeRFTPMLP's function in its concatenating form: every Dense on the
    concatenation of its inputs, the bottleneck and views_0 on every
    view's rows, then the mean over views."""
    mean = lambda t: t.reshape((num_views, -1) + t.shape[1:]).mean(0)
    x = torch.cat([x, local_latent, world_latent], dim=-1)
    inputs = x
    for idx in range(mlp.netdepth):
        x = F.relu(getattr(mlp, f"pts_{idx}")(x))
        if idx == mlp.combine_layer:
            bottleneck = mlp.bottleneck(x)
            x = mean(x)
        if mlp._skip(idx):
            x = torch.cat([x, inputs], dim=-1)
    raw_density = mlp.density(x)
    cond = viewdirs_enc[..., None, :].expand(
        bottleneck.shape[:-1] + (viewdirs_enc.shape[-1],))
    h = torch.cat([bottleneck, cond], dim=-1)
    for idx in range(mlp.netdepth_condition):
        h = getattr(mlp, f"views_{idx}")(h)
        if idx == 0:
            h = mean(h)
        h = F.relu(h)
    return mlp.rgb(h), raw_density


def _mlp_case(point_dim, num_views, seed=0):
    """A NeRFTPMLP with random weights and biases and its inputs, all
    drawn from one seeded generator: the concatenating form's arguments
    (x, viewdirs_enc, world, local, num_views) and the block-split
    forward's (the same inputs assembled in place: `_in_place`)."""
    g = torch.Generator().manual_seed(seed)
    d_pe = point_dim * 21
    mlp = NeRFTPMLP(d_pe + 256, 27, generator=g)
    with torch.no_grad():
        for p in mlp.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g))
    rows = num_views * MLP_ROWS["b"]
    s = MLP_ROWS["s"]
    args = (torch.randn(rows, s, d_pe, generator=g),
            torch.randn(rows, 27, generator=g),
            torch.randn(rows, s, 128, generator=g),
            torch.randn(rows, s, 128, generator=g), num_views)
    return mlp, args


def _in_place(x, viewdirs_enc, world_latent, local_latent, num_views):
    """The block-split forward's arguments: the inputs as NeRFTP
    assembles them, rows of a buffer whose row stride is rounded up to 4
    floats, columns [world | local | pos_enc]."""
    d_in = x.shape[-1] + 256
    buf = torch.full((x.shape[0] * x.shape[1], -(-d_in // 4) * 4),
                     float("nan"))
    buf[:, :d_in] = torch.cat([world_latent, local_latent, x],
                              dim=-1).reshape(-1, d_in)
    return buf[:, :d_in], viewdirs_enc, num_views


@pytest.mark.parametrize("num_views", [1, 3])
@pytest.mark.parametrize("point_dim", [3, 4], ids=["fg319", "bg340"])
def test_nerftp_mlp_blocks_match_concatenation(point_dim, num_views):
    """The block-split forward equals the concatenating one in outputs and
    in every parameter's gradient of a random scalar loss, to f32
    reordering (1e-5 relative to each tensor's largest entry)."""
    mlp, args = _mlp_case(point_dim, num_views)
    g = torch.Generator().manual_seed(1)
    weight = [torch.randn(MLP_ROWS["b"], MLP_ROWS["s"], c, generator=g)
              for c in (3, 1)]

    def run(fn):
        mlp.zero_grad()
        outs = fn(*args)
        sum((o * w).sum() for o, w in zip(outs, weight)).backward()
        return outs, {n: p.grad.clone() for n, p in mlp.named_parameters()}

    (rgb, density), grads = run(lambda *a: mlp(*_in_place(*a)))
    (ref_rgb, ref_density), ref_grads = run(
        lambda *a: _concat_forward(mlp, *a))
    assert rgb.shape == ref_rgb.shape == (MLP_ROWS["b"], MLP_ROWS["s"], 3)
    assert density.shape == ref_density.shape == (MLP_ROWS["b"],
                                                  MLP_ROWS["s"], 1)
    pairs = [("raw_rgb", rgb, ref_rgb), ("raw_density", density, ref_density)]
    pairs += [(n, grads[n], ref_grads[n]) for n in ref_grads]
    for name, ours, ref in pairs:
        scale = ref.abs().max().item()
        assert scale > 0, name
        torch.testing.assert_close(ours, ref, rtol=0, atol=1e-5 * scale,
                                   msg=name)


def test_nerftp_mlp_concatenates_only_its_inputs(monkeypatch):
    """One forward makes no torch.cat over per-sample activations: its
    inputs arrive assembled in place (NeRFTP._inputs); the parameters
    keep the concatenating layout's names and shapes."""
    mlp, args = _mlp_case(3, 3)
    args = _in_place(*args)
    rows = args[0].shape[0]
    cats = []
    cat = torch.cat

    def counting_cat(tensors, *a, **kw):
        out = cat(tensors, *a, **kw)
        if out.numel() // out.shape[-1] == rows:     # a row per sample
            cats.append(tuple(out.shape))
        return out

    monkeypatch.setattr(torch, "cat", counting_cat)
    mlp(*args)
    assert cats == []
    shapes = {"pts_0": (128, 319), "pts_1": (128, 128),
              "pts_2": (128, 128), "pts_3": (128, 447),
              "bottleneck": (128, 128), "density": (1, 128),
              "views_0": (64, 155), "views_1": (64, 64), "rgb": (3, 64)}
    expected = {}
    for name, shape in shapes.items():
        expected[f"{name}.weight"] = shape
        expected[f"{name}.bias"] = shape[:1]
    assert {k: tuple(v.shape) for k, v in mlp.state_dict().items()} \
        == expected
