"""The JAX NeRFTP's width and sampling fields in the port, against the JAX
package on the CPU: `plane_dim`, `local_proj_dim`, `pillar_width` and
`depth_fc_layers` (GridEncoder's widths), `lindisp`, `density_noise` and
`num_levels`, and the baselines' `lindisp` and `noise_std` (VanillaNeRF,
PixelNeRF). Tiny sizes: grid (8, 8, 4), encoder width 64, lift 32, 8
proposal or coarse and 6 fine samples, 40x30 fixture scenes, float32; the
narrow knobs are plane_dim 32, local_proj_dim 32, pillar_width 8 and
depth_fc_layers 1. JAX inits reach the port through
weights.from_flax_flat.

Tolerances:
- NeRFTP forward, levels 0 and 1: 1e-4 absolute plus 1e-4 relative, as
  tests/test_torch_neo360_ref.py (convolutions and matmuls sum in another
  order in the two frameworks); a third level (`num_levels` 3): 1e-3
  absolute plus 1e-4 relative (it resamples level 1's histograms, whose
  ~1.5e-5 differences move its bg points by up to 2.3e-4, measured).
- One joint gradient of the stage loss (img2mse + interlevel +
  distortion): 1e-4 relative and 2e-3 absolute of the largest entry,
  leaves under 5% of it skipped, as tests/test_torch_train.py:149 records
  (the loss's float32 conditioning).
- The NeRF++ samplers with `lindisp`: 1e-6 absolute plus 1e-6 relative
  (the same float32 operations), the sample points 1e-5 (the bg points'
  trigonometry, as tests/test_torch_core.py).
- VanillaNeRF: 1e-5 relative plus 1e-6 absolute, as
  tests/test_torch_vanilla.py; PixelNeRF: 1e-4 relative plus 1e-5
  absolute, as tests/test_torch_pixelnerf.py.

Randomized forwards (`density_noise`, `noise_std`, stratified `lindisp`)
see the same uniforms on both sides: `jax.random.uniform`, called from the
JAX samplers or models, returns seeded numpy draws and records them; the
port takes the samplers' draws through `sampling._uniform`, in order, and
the density noise through the models' `noise_u` argument (`jax.random`
draws cannot be matched).
"""

import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo360_tpu.core import sampling as jsamp
from neo360_tpu.data.nerds360 import NeRDS360 as JNeRDS360
from neo360_tpu.data.nerds360_ae import NeRDS360AE as JNeRDS360AE
from neo360_tpu.models import neo360 as jneo
from neo360_tpu.models import pixelnerf as jpix
from neo360_tpu.models import vanilla as jvan
from neo360_tpu.ops.losses import img2mse as jimg2mse
from neo360_tpu_torch import cli, weights
from neo360_tpu_torch.config import preset
from neo360_tpu_torch.core import sampling
from neo360_tpu_torch.models import neo360
from neo360_tpu_torch.models.neo360 import NeRFTP
from neo360_tpu_torch.models.pixelnerf import PixelNeRF
from neo360_tpu_torch.models.vanilla import VanillaNeRF
from neo360_tpu_torch.nn.layers import BatchNorm
from neo360_tpu_torch.nn.triplane import GridEncoder, TriPillarAggregator

torch.set_num_threads(1)

TINY = dict(grid_size=(8, 8, 4), encoder_width=64, lift_dim=32,
            num_prop_samples=8, num_coarse_samples=8, num_fine_samples=6)
KNOBS = dict(plane_dim=32, local_proj_dim=32, pillar_width=8,
             depth_fc_layers=1)
WH = (40, 30)
SRC = neo360.SRC_KEYS
RAYS = neo360.RAY_KEYS
N_RAYS = 16
OUT = ("rgb", "fg_rgb", "bg_rgb", "fg_acc", "bg_acc", "bg_lambda",
       "fg_weights", "bg_weights", "fg_tvals", "bg_tvals", "far",
       "fg_sdist", "bg_sdist")


def _flat(tree, prefix):
    return flax.traverse_util.flatten_dict({prefix: tree}, sep="/")


def _close(ours, ref, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(ours, np.float32),
                               np.asarray(ref, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def _jax_nerftp(proposal, **kw):
    return jneo.NeRFTP(num_src_views=3, use_proposal=proposal,
                       remat_encoder=False, **TINY, **KNOBS, **kw)


def _port_nerftp(variables, proposal, **kw):
    model = NeRFTP(num_src_views=3, use_proposal=proposal,
                   remat_encoder=False, **TINY, **KNOBS, **kw)
    weights.load_into(model, weights.from_flax_flat(
        flax.traverse_util.flatten_dict(variables, sep="/")))
    return model.eval()


class _Uniforms:
    """jax.random.uniform, when called from the JAX samplers or models,
    returns seeded numpy draws and records them with the calling module;
    the port's `sampling._uniform` returns the samplers' draws in order
    (or the uniforms it is given)."""

    def __init__(self, monkeypatch, seed):
        self.rng = np.random.default_rng(seed)
        self.draws = []
        real = jax.random.uniform
        modules = (jsamp.__name__, jneo.__name__, jvan.__name__,
                   jpix.__name__)

        def jax_uniform(key, shape=(), dtype=jnp.float32, *args, **kw):
            caller = sys._getframe(1).f_globals["__name__"]
            if caller not in modules:
                return real(key, shape, dtype, *args, **kw)
            u = self.rng.uniform(size=tuple(shape)).astype(np.float32)
            self.draws.append((caller, u))
            return jnp.asarray(u, dtype)

        monkeypatch.setattr(jax.random, "uniform", jax_uniform)
        self.monkeypatch = monkeypatch

    def to_port(self):
        """Feed the recorded sampler draws to the port; returns the
        density-noise draws, in order."""
        queue = [u for m, u in self.draws if m == jsamp.__name__]

        def port_uniform(shape, like, u, generator):
            if u is None:
                u = torch.as_tensor(queue.pop(0))
            assert tuple(u.shape) == tuple(shape), (u.shape, shape)
            return u.to(like.device, like.dtype)

        self.monkeypatch.setattr(sampling, "_uniform", port_uniform)
        self.queue = queue
        return [torch.as_tensor(u) for m, u in self.draws
                if m != jsamp.__name__]


@pytest.fixture(scope="module")
def sample(multi_scene_root):
    return JNeRDS360AE(multi_scene_root, "test", WH, 3).sample_test(0, 1)


_VARIABLES = {}


def _init(proposal, sample):
    """JAX variables at the narrow knobs (cached per mode), with random
    running statistics."""
    if proposal in _VARIABLES:
        return _VARIABLES[proposal]
    model = _jax_nerftp(proposal)
    rays = {k: jnp.asarray(sample[k][:4] if k in RAYS else sample[k])
            for k in RAYS + SRC}
    variables = jax.jit(lambda r: model.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        r, True, False))(rays)
    rng = np.random.default_rng(1)
    bs = jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.uniform(0.5, 2.0, v.shape), jnp.float32),
        variables["batch_stats"])
    _VARIABLES[proposal] = {"params": variables["params"],
                            "batch_stats": bs}
    return _VARIABLES[proposal]


def _rays(sample, n=N_RAYS):
    return {k: jnp.asarray(sample[k][:n] if k in RAYS else sample[k])
            for k in RAYS + SRC}


def _forward_pair(proposal, sample, randomized=False, monkeypatch=None,
                  **fields):
    """(port levels, JAX levels) of one batch, both encoding with the
    source stack's BatchNorm statistics, depth out."""
    variables = _init(proposal, sample)
    model = _jax_nerftp(proposal, **fields)
    rays = _rays(sample)
    uniforms = _Uniforms(monkeypatch, 5) if randomized else None
    ref = jax.jit(lambda v, r: model.apply(
        v, r, randomized, False, out_depth=True, train=True,
        mutable=["batch_stats"], rngs={"sampling": jax.random.PRNGKey(2)}
    )[0])(variables, rays)
    port = _port_nerftp(variables, proposal, **fields)
    noise = uniforms.to_port() if randomized else []
    trays = {k: torch.tensor(np.asarray(a)) for k, a in rays.items()}
    with torch.no_grad():
        enc = port.encode(*(trays[k] for k in SRC), True)
        out = port(trays, enc, False, out_depth=True, randomized=randomized,
                   noise_u=list(zip(noise[::2], noise[1::2])) or None)
    if randomized:
        assert not uniforms.queue
    return out, ref


def _assert_levels(out, ref):
    """Levels 0 and 1 within 1e-4; a third level within 1e-3 absolute (it
    resamples level 1's histograms, whose float32 differences of ~1.5e-5
    move its bg points by up to 2.3e-4 and its bg rgb by 4.2e-4, as
    measured)."""
    assert len(out) == len(ref)
    for level, (o, r) in enumerate(zip(out, ref)):
        for k in OUT + ("depth", "fg_depth"):
            _close(o[k], r[k], rtol=1e-4, atol=1e-4 if level < 2 else 1e-3,
                   msg=f"{level} {k}")


@pytest.mark.parametrize("lindisp", [False, True])
@pytest.mark.parametrize("proposal", [True, False])
def test_narrow_knobs_forward_matches_jax(sample, proposal, lindisp):
    """NeRFTP at plane_dim 32, local_proj_dim 32, pillar_width 8 and
    depth_fc_layers 1, with the proposal (neo360_fast) and without it
    (neo360), deterministic sampling, level-0 fg samples even in depth or
    (`lindisp`) in inverse depth: every output of both levels."""
    out, ref = _forward_pair(proposal, sample, lindisp=lindisp)
    assert out[1]["fg_weights"].shape == (N_RAYS, 7 if proposal else 15)
    _assert_levels(out, ref)


@pytest.mark.parametrize("proposal", [True, False])
def test_density_noise_matches_jax(sample, proposal, monkeypatch):
    """`density_noise` 0.5 in a randomized forward: the JAX model's
    U[0, 0.5) added to every conditioned level's raw density, fg then bg,
    given to the port as `noise_u`; the samplers' stratified and
    inverse-CDF draws shared too."""
    out, ref = _forward_pair(proposal, sample, True, monkeypatch,
                             density_noise=0.5, lindisp=True)
    _assert_levels(out, ref)


def test_density_noise_is_drawn_only_in_randomized_forwards(sample):
    """Without `randomized` the noise changes nothing; with it the port
    draws its own noise from the sampling generator, after each level's
    samples (so the samples stay those of a model without noise)."""
    variables = _init(False, sample)
    trays = {k: torch.tensor(np.asarray(a))
             for k, a in _rays(sample).items()}
    outs = []
    for noise in (0.0, 2.0):
        port = _port_nerftp(variables, False, density_noise=noise)
        with torch.no_grad():
            enc = port.encode(*(trays[k] for k in SRC), True)
            outs.append([port(trays, enc, randomized=r,
                              generator=torch.Generator().manual_seed(3))
                         for r in (False, True)])
    (plain0, rnd0), (plain1, rnd1) = outs
    for k in OUT:
        torch.testing.assert_close(plain1[1][k], plain0[1][k], rtol=0,
                                   atol=0)
    torch.testing.assert_close(rnd1[0]["fg_tvals"], rnd0[0]["fg_tvals"],
                               rtol=0, atol=0)
    assert not torch.equal(rnd1[0]["fg_weights"], rnd0[0]["fg_weights"])


@pytest.mark.parametrize("proposal,num_levels", [(True, 1), (True, 3),
                                                 (False, 3)])
def test_num_levels_matches_jax(sample, proposal, num_levels):
    """`num_levels` other than 2 runs in the JAX model on the CPU, with
    and without the proposal; the port runs the same levels: level 0,
    then levels that each resample the one before through the fine MLPs
    and the fine local table."""
    out, ref = _forward_pair(proposal, sample, num_levels=num_levels)
    assert len(out) == num_levels
    _assert_levels(out, ref)


def test_build_model_takes_the_width_fields(sample):
    """cli.build_model passes the Config's width fields to NeRFTP: the
    JAX init at those widths loads into it, and its forward is the JAX
    model's."""
    variables = _init(True, sample)
    cfg = preset("neo360_fast", bf16=False, **TINY, **KNOBS)
    port = cli.build_model(cfg, "cpu")
    weights.load_into(port, weights.from_flax_flat(
        flax.traverse_util.flatten_dict(variables, sep="/")))
    enc = port.encoder
    assert (enc.plane_dim, enc.tri_pillar.f, enc.depth_fc.hidden,
            port.local_proj_fg_f.weight.shape) == (32, 8, ["fc0"], (32, 512))
    out_ref = _forward_pair(True, sample)
    trays = {k: torch.tensor(np.asarray(a))
             for k, a in _rays(sample).items()}
    with torch.no_grad():
        out = port(trays, port.encode(*(trays[k] for k in SRC), True),
                   out_depth=True)
    _assert_levels(out, out_ref[1])


def _compare_leaves(ours, ref, rtol, atol, min_compared):
    scale = max(float(np.abs(v).max()) for v in ref.values())
    compared = 0
    for k, r in ref.items():
        o = ours[k]
        if max(np.abs(r).max(), np.abs(o).max()) < 5e-2 * scale:
            continue
        np.testing.assert_allclose(o / scale, r / scale, rtol=rtol,
                                   atol=atol, err_msg=k)
        compared += 1
    assert compared >= min_compared, compared


@pytest.mark.parametrize("lindisp", [False, True])
def test_narrow_knobs_stage_gradient_matches_jax(multi_scene_root, lindisp):
    """d(stage loss)/d(every parameter) at the narrow knobs, proposal
    mode, one step of a 2-scene stage's first scene: BatchNorm in training
    mode, deterministic sampling, the loss img2mse + interlevel +
    distortion."""
    ds = JNeRDS360AE(multi_scene_root, "train", WH, 3, N_RAYS)
    stage = ds.sample_train_stage(np.random.default_rng(0), 2, n_scenes=2)
    batch = {k: jnp.asarray(stage[k][0, 0]) for k in RAYS + ("target",)}
    src = {k: jnp.asarray(stage[k][0]) for k in SRC}
    model = _jax_nerftp(True, lindisp=lindisp)
    variables = _init(True, dict({k: np.asarray(batch[k]) for k in RAYS},
                                 **{k: np.asarray(v) for k, v in
                                    src.items()}))

    def joint_loss(params):
        rays = dict({k: batch[k] for k in RAYS}, **src)
        out, _ = model.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             rays, False, False, train=True,
                             mutable=["batch_stats"])
        l1 = jimg2mse(out[1]["rgb"], batch["target"])
        return (l1 + jneo.neo360_interlevel_loss(out)
                + jneo.neo360_distortion_loss(out))

    g = jax.jit(jax.grad(joint_loss))(variables["params"])
    ref = {k: v.numpy() for k, v in
           weights.from_flax_flat(_flat(g, "params")).items()}

    port = _port_nerftp(variables, True, lindisp=lindisp).train()
    tsrc = {k: torch.as_tensor(np.asarray(v)) for k, v in src.items()}
    trays = {k: torch.as_tensor(np.asarray(batch[k])) for k in RAYS}
    out = port(dict(trays, **tsrc), port.encode(*(tsrc[k] for k in SRC),
                                                 True))
    loss, _ = neo360.neo360_loss(out, torch.as_tensor(
        np.asarray(batch["target"])))
    named = dict(port.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    for m in port.modules():
        if isinstance(m, BatchNorm):
            m.pending.clear()
    ours = {k: gr.numpy() for k, gr in zip(named, grads)}
    assert set(ours) == set(ref)
    _compare_leaves(ours, ref, rtol=1e-4, atol=2e-3, min_compared=30)


@pytest.mark.parametrize("randomized", [False, True])
@pytest.mark.parametrize("in_sphere", [True, False])
def test_nerfpp_sampler_lindisp_matches_jax(in_sphere, randomized,
                                            monkeypatch):
    """`sample_along_rays_nerfpp(lindisp=True)`: fg t in inverse depth
    between near and the sphere exit; bg (in_sphere=False) ignores it, as
    the JAX function does."""
    rng = np.random.default_rng(6)
    o = rng.uniform(-0.3, 0.3, (12, 3)).astype(np.float32)
    d = rng.normal(size=(12, 3)).astype(np.float32)
    near = np.full((12, 1), 1e-4, np.float32)
    far = rng.uniform(0.5, 1.5, (12, 1)).astype(np.float32)
    uniforms = _Uniforms(monkeypatch, 7)
    ref = jsamp.sample_along_rays_nerfpp(
        jnp.asarray(o), jnp.asarray(d), 9, jnp.asarray(near),
        jnp.asarray(far), randomized, True, in_sphere=in_sphere,
        far_uncontracted=3.0,
        key=jax.random.PRNGKey(0) if randomized else None)
    uniforms.to_port()
    ours = sampling.sample_along_rays_nerfpp(
        torch.as_tensor(o), torch.as_tensor(d), 9, torch.as_tensor(near),
        torch.as_tensor(far), in_sphere, 3.0, randomized, lindisp=True)
    assert not uniforms.queue and len(ours) == len(ref)
    _close(ours[0], ref[0], rtol=1e-6, atol=1e-6)
    for a, b in zip(ours[1:], ref[1:]):
        _close(a, b, rtol=1e-5, atol=1e-5)
    if in_sphere and not randomized:
        inv = 1.0 / ours[0].double()
        steps = inv[:, 1:] - inv[:, :-1]
        torch.testing.assert_close(steps, steps[:, :1].expand_as(steps),
                                   rtol=1e-4, atol=0)


def test_tri_pillar_hidden_width_knob():
    """The port's twin of tests/test_neo360.py:458: `hidden_features`
    narrows only the aggregator's hidden layer."""
    tri = TriPillarAggregator(features=32, hidden_features=8)
    assert tri.hidden_lat.weight.shape == (3 * 8, 32)
    assert tri.coord_w.shape == (3, 8) and tri.hidden_b.shape == (3, 8)
    assert all(getattr(tri, f"out_{n}").weight.shape == (1, 8)
               for n in ("yz", "xz", "xy"))
    outs = tri(torch.zeros(2, 5, 32), torch.zeros(2, 5, 3))
    assert all(o.shape == (2, 5, 1) for o in outs)


def test_depth_fc_layers_knob(multi_scene_root):
    """The port's twin of tests/test_neo360.py:474: depth_fc_layers=1
    drops fc1 from DepthPillarEncoder, and an anisotropic grid threads
    through the encoder end to end; GridEncoder's widths default to the
    reference's."""
    model = NeRFTP(num_fine_samples=4, grid_size=(8, 8, 4),
                   encoder_width=64, lift_dim=32, depth_fc_layers=1,
                   use_proposal=True, num_prop_samples=4)
    names = {k for k in model.state_dict() if ".depth_fc." in k}
    assert names == {"encoder.depth_fc.fc0.weight",
                     "encoder.depth_fc.fc0.bias",
                     "encoder.depth_fc.depth.weight",
                     "encoder.depth_fc.depth.bias"}
    batch = JNeRDS360AE(multi_scene_root, "train", WH, 3, 8).sample_train(
        np.random.default_rng(0))
    rays = {k: torch.as_tensor(batch[k]) for k in RAYS + SRC}
    with torch.no_grad():
        out = model(rays, model.encode(*(rays[k] for k in SRC), True))
    assert out[-1]["rgb"].shape == rays["rays_o"].shape
    enc = GridEncoder(grid_size=(8, 8, 4), latent_size=64, lift_dim=32)
    assert (enc.plane_dim, enc.tri_pillar.f, enc.depth_fc.hidden,
            enc.floorplan_xy.conv4.weight.shape[0]) == (128, 64,
                                                        ["fc0", "fc1"], 128)


# --- the baselines' lindisp and noise_std ---------------------------------

@pytest.fixture(scope="module")
def vanilla_sample(micro_scene):
    sample = JNeRDS360(micro_scene, "test", WH).image_rays(1)
    idx = np.random.default_rng(5).choice(40 * 30, N_RAYS, replace=False)
    return {k: sample[k][idx] for k in RAYS}


@pytest.mark.parametrize("randomized", [False, True])
def test_vanilla_lindisp_and_noise_match_jax(vanilla_sample, randomized,
                                             monkeypatch):
    """VanillaNeRF with `lindisp` (coarse samples in inverse depth) and
    `noise_std` 1.0 (U[0, 1) on every level's raw density in a randomized
    forward; the port takes the JAX draws as `noise_u`)."""
    fields = dict(num_coarse_samples=8, num_fine_samples=8, lindisp=True,
                  noise_std=1.0)
    model = jvan.VanillaNeRF(**fields)
    rays = {k: jnp.asarray(v) for k, v in vanilla_sample.items()}
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "sampling": jax.random.PRNGKey(1)}, rays,
                           False, False, 0.2, 3.0)
    uniforms = _Uniforms(monkeypatch, 8) if randomized else None
    ref = model.apply(variables, rays, randomized, False, 0.2, 3.0,
                      rngs={"sampling": jax.random.PRNGKey(2)})
    noise = uniforms.to_port() if randomized else None
    port = VanillaNeRF(**fields)
    weights.load_into(port, weights.from_flax_flat(
        _flat(variables["params"], "params")))
    with torch.no_grad():
        ours = port({k: torch.as_tensor(v) for k, v in
                     vanilla_sample.items()}, False, 0.2, 3.0,
                    randomized=randomized, noise_u=noise)
    if randomized:
        assert not uniforms.queue and len(noise) == 2
    for lo, lr in zip(ours, ref):
        for k in ("rgb", "acc", "depth", "weights", "t_vals"):
            _close(lo[k], lr[k], rtol=1e-5, atol=1e-6, msg=k)


@pytest.mark.parametrize("randomized", [False, True])
def test_pixelnerf_lindisp_and_noise_match_jax(sample, randomized,
                                               monkeypatch):
    """PixelNeRF with `lindisp` and `noise_std` 1.0, as the vanilla test:
    both levels, BatchNorm on the source stack's statistics."""
    fields = dict(num_coarse_samples=8, num_fine_samples=8, lindisp=True,
                  noise_std=1.0)
    model = jpix.PixelNeRF(num_src_views=3, **fields)
    rays = _rays(sample)
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "sampling": jax.random.PRNGKey(1)}, rays, False,
                           False, 0.02, 3.0)
    latent, _ = model.apply(variables, rays["src_imgs"], True,
                            method=jpix.PixelNeRF.encode,
                            mutable=["batch_stats"])
    uniforms = _Uniforms(monkeypatch, 9) if randomized else None
    ref = model.apply(variables, rays, randomized, False, 0.02, 3.0,
                      latent=latent, rngs={"sampling": jax.random.PRNGKey(2)})
    noise = uniforms.to_port() if randomized else None
    port = PixelNeRF(num_src_views=3, **fields)
    weights.load_into(port, weights.from_flax_flat({
        **_flat(variables["params"], "params"),
        **_flat(variables["batch_stats"], "batch_stats")}))
    port.eval()
    trays = {k: torch.as_tensor(np.asarray(v)) for k, v in rays.items()}
    with torch.no_grad():
        ours = port(trays, port.encode(trays["src_imgs"], True),
                    randomized=randomized, noise_u=noise)
    if randomized:
        assert not uniforms.queue and len(noise) == 2
    for lo, lr in zip(ours, ref):
        for k in ("rgb", "acc", "depth", "weights", "t_vals"):
            _close(lo[k], lr[k], rtol=1e-4, atol=1e-5, msg=k)
