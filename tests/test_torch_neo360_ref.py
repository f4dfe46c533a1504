"""Parity of the port's `neo360` reference preset with the JAX package, on
the same weights (converted through weights.from_flax_flat) and the same
fixture scenes, at a tiny size: grid (8, 8, 8) (and (8, 8, 40) for Z > 32),
encoder width 64, the 512-channel lift, 8 coarse and 6 fine samples,
40x30 scenes, float32.

Tolerances:
- `sample_pdf_nerfpp(merge=True)`: 1e-5 absolute plus 1e-5 relative, as
  tests/test_torch_core.py (the bg points' float32 trigonometry rounds
  differently in the two frameworks).
- The forward, both levels: 1e-4 absolute plus 1e-4 relative, as
  tests/test_torch_neo360.py (the convolutions and matmuls sum in another
  order in the two frameworks).
- The per-step loss: 1e-5 relative. Its gradient: 1e-4 relative and 2e-3
  absolute of the largest entry, leaves under 5% of it skipped, as
  tests/test_torch_train.py:149 (the loss's float32 conditioning).
- One Adam step with the global clip, on the same gradients: 1e-6 of the
  largest parameter update. BatchNorm buffers after the step: 1e-5
  relative plus 1e-6 (a floorplan BatchNorm's biased batch variance,
  E[x^2] - E[x]^2 over 3 views, sums in another order: 2.1e-6 relative
  measured).
- Remat on against remat off (port only): equal bits.

Both sides draw the same uniforms: the JAX package's `jax.random.uniform`
and the port's `sampling._uniform` are replaced, while the step runs, by
one list of numpy draws taken in the order both make them (per level, fg
then bg).
"""

import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo360_tpu import cli as jcli
from neo360_tpu.config import preset as jpreset
from neo360_tpu.core import sampling as jsamp
from neo360_tpu.data.nerds360_ae import NeRDS360AE as JNeRDS360AE
from neo360_tpu.models.neo360 import NeRFTP as JNeRFTP
from neo360_tpu.train import loop as jloop
from neo360_tpu_torch import cli, weights
from neo360_tpu_torch.config import preset
from neo360_tpu_torch.core import sampling
from neo360_tpu_torch.nn.layers import BatchNorm
from neo360_tpu_torch.nn.triplane import GridEncoder
from neo360_tpu_torch.train import loop

torch.set_num_threads(1)

TINY = dict(encoder_width=64, num_coarse_samples=8, num_fine_samples=6)
WH = (40, 30)
SRC = ("src_imgs", "src_poses", "src_focal", "src_c")
RAYS = ("rays_o", "rays_d", "viewdirs")
N_RAYS = 16


def _flat(tree, prefix):
    return flax.traverse_util.flatten_dict({prefix: tree}, sep="/")


def _jax_model(grid):
    return JNeRFTP(num_src_views=3, use_proposal=False, remat_encoder=False,
                   grid_size=grid, **TINY)


_VARIABLES = {}


def _init(model, sample):
    """Variables of `model` (cached per grid: the examples share shapes),
    with random running statistics."""
    if model.grid_size in _VARIABLES:
        return _VARIABLES[model.grid_size]
    rays = {k: jnp.asarray(sample[k][:4] if k in RAYS else sample[k])
            for k in RAYS + SRC}
    variables = jax.jit(lambda r: model.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        r, True, False))(rays)
    rng = np.random.default_rng(1)    # random running statistics
    bs = jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.uniform(0.5, 2.0, v.shape), jnp.float32),
        variables["batch_stats"])
    out = {"params": variables["params"], "batch_stats": bs}
    _VARIABLES[model.grid_size] = out
    return out


def _port(variables, grid, **kw):
    model = cli.build_model(preset("neo360", grid_size=grid, **TINY, **kw),
                            "cpu")
    weights.load_into(model, weights.from_flax_flat(
        flax.traverse_util.flatten_dict(variables, sep="/")))
    return model


def _bn_buffers(model):
    return {f"{name}.{b}": getattr(m, b).clone()
            for name, m in model.named_modules() if isinstance(m, BatchNorm)
            for b in ("running_mean", "running_var")}


@pytest.mark.parametrize("in_sphere", [True, False])
@pytest.mark.parametrize("randomized", [False, True])
def test_merged_resampling_matches_jax(in_sphere, randomized):
    """sample_pdf_nerfpp(merge=True): 5 draws sorted with the 9 level-0
    t_vals (bg: descending), fg and bg, deterministic and on the uniforms
    the JAX function draws."""
    rng = np.random.default_rng(5)
    o = rng.normal(size=(8, 3)).astype(np.float32) * 0.3
    d = rng.normal(size=(8, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    far = rng.uniform(1.0, 2.0, size=(8, 1)).astype(np.float32)
    t = np.sort(rng.uniform(0, 1, size=(8, 9)), -1).astype(np.float32)
    if not in_sphere:
        t = t[:, ::-1].copy()
    mids = 0.5 * (t[:, 1:] + t[:, :-1])
    w = rng.uniform(0, 1, size=(8, 7)).astype(np.float32) + 0.01
    key = jax.random.PRNGKey(13)
    u = np.asarray(jax.random.uniform(key, (8, 5), dtype=jnp.float32))
    tw = torch.as_tensor(w).requires_grad_()
    ours = sampling.sample_pdf_nerfpp(
        torch.as_tensor(mids), tw, torch.as_tensor(o), torch.as_tensor(d),
        torch.as_tensor(t), 5, in_sphere, far=torch.as_tensor(far),
        randomized=randomized, u=torch.as_tensor(u) if randomized else None)
    ref = jsamp.sample_pdf_nerfpp(
        jnp.asarray(mids), jnp.asarray(w), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t), 5, randomized, in_sphere, far=jnp.asarray(far),
        key=key)
    assert ours[0].shape == (8, 14) and not ours[0].requires_grad
    assert len(ours) == len(ref) == (2 if in_sphere else 3)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


@pytest.fixture(scope="module")
def test_sample(multi_scene_root):
    from neo360_tpu.data.nerds360_ae import NeRDS360AE
    return NeRDS360AE(multi_scene_root, "test", WH, 3).sample_test(0, 1)


@pytest.mark.parametrize("grid", [(8, 8, 8), (8, 8, 40)])
def test_forward_matches_jax(test_sample, grid):
    """NeRFTP without the proposal, randomized=False, with depth, batch-
    statistics encode: both levels' composites, weights and t_vals (8+1
    coarse and 8+6+1 merged fine points per branch); at Z = 40 the pillar
    collapse's plain version runs on a grid the card's kernel C takes only
    with four z chunks."""
    model = _jax_model(grid)
    variables = _init(model, test_sample)
    rays = {k: jnp.asarray(test_sample[k][:24] if k in RAYS
                           else test_sample[k]) for k in RAYS + SRC}
    ref = jax.jit(lambda v, r: model.apply(
        v, r, False, False, out_depth=True, train=True,
        mutable=["batch_stats"])[0])(variables, rays)
    port = _port(variables, grid)
    trays = {k: torch.tensor(np.asarray(a)) for k, a in rays.items()}
    with torch.no_grad():
        enc = port.encode(*(trays[k] for k in SRC), True)
        out = port(trays, enc, False, out_depth=True)
    assert len(enc[1]) == 2      # the coarse and the fine local table
    assert out[0]["fg_weights"].shape == (24, 9)
    assert out[1]["fg_weights"].shape == (24, 15)
    for level in range(2):
        for k in ("rgb", "fg_rgb", "bg_rgb", "fg_acc", "bg_acc", "bg_lambda",
                  "depth", "fg_depth", "fg_weights", "bg_weights",
                  "fg_tvals", "bg_tvals", "far", "fg_sdist", "bg_sdist"):
            np.testing.assert_allclose(out[level][k].numpy(),
                                       np.asarray(ref[level][k]), atol=1e-4,
                                       rtol=1e-4, err_msg=f"{level} {k}")


def _shared_uniforms(monkeypatch, draws):
    """Both frameworks take their uniforms from copies of `draws`, in
    order."""
    jq, tq = list(draws), list(draws)
    real = jax.random.uniform

    def jax_uniform(key, shape, dtype=jnp.float32, *args, **kw):
        if sys._getframe(1).f_globals["__name__"] != jsamp.__name__:
            return real(key, shape, dtype, *args, **kw)
        u = jq.pop(0)
        assert u.shape == tuple(shape), (u.shape, shape)
        return jnp.asarray(u, dtype)

    def port_uniform(shape, like, u, generator):
        u = tq.pop(0)
        assert u.shape == tuple(shape), (u.shape, shape)
        return torch.as_tensor(u).to(like.device, like.dtype)

    monkeypatch.setattr(jax.random, "uniform", jax_uniform)
    monkeypatch.setattr(sampling, "_uniform", port_uniform)
    return jq, tq


@pytest.fixture(scope="module")
def step_setup(multi_scene_root):
    """The JAX model and variables, one sample_train draw and the uniforms
    of one randomized step."""
    ds = JNeRDS360AE(multi_scene_root, "train", WH, 3, N_RAYS)
    batch = ds.sample_train(np.random.default_rng(0))
    model = _jax_model((8, 8, 8))
    variables = _init(model, batch)
    rng = np.random.default_rng(3)
    n0, n1 = TINY["num_coarse_samples"] + 1, TINY["num_fine_samples"]
    draws = [rng.uniform(size=(N_RAYS, n)).astype(np.float32)
             for n in (n0, n0, n1, n1)]
    return model, variables, batch, draws


def _jax_step(monkeypatch, step_setup):
    """value_and_grad of the JAX CLI's neo360 loss and one optax step of
    the JAX CLI's optimizer (clip_by_global_norm(0.05), adam)."""
    model, variables, batch, draws = step_setup
    jcfg = jpreset("neo360", img_wh=WH)
    loss_fn = jcli.make_loss_fn(jcfg, model, variables)
    keys = ("rays_o", "rays_d", "viewdirs") + SRC + ("target",)
    jb = {k: jnp.asarray(batch[k]) for k in keys}
    jq, _ = _shared_uniforms(monkeypatch, draws)
    (loss, (metrics, new_bs)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"],
                                variables["batch_stats"], jb,
                                jax.random.PRNGKey(7))
    assert not jq
    tx = jcli.build_optimizer(jcfg)
    upd, _ = tx.update(grads, tx.init(variables["params"]),
                       variables["params"])
    return float(loss), metrics, new_bs, grads, upd


def test_per_step_loss_gradient_adam_and_batchnorm_match_jax(
        monkeypatch, step_setup):
    """One per-step training step of the neo360 preset: the loss
    (l0 + l1 + distortion) and its gradient against jax.value_and_grad of
    the JAX CLI's make_loss_fn; the port's one Adam over every parameter
    with the global clip, fed the JAX gradient, against the optax chain;
    the BatchNorm running statistics the port's step commits against the
    JAX step's new batch_stats (momentum 0.9, biased variance)."""
    model, variables, batch, draws = step_setup
    loss, metrics, new_bs, grads, upd = _jax_step(monkeypatch, step_setup)

    port = _port(variables, (8, 8, 8)).train()
    cfg = preset("neo360", grid_size=(8, 8, 8), img_wh=WH, **TINY)
    _, tq = _shared_uniforms(monkeypatch, draws)
    tb = {k: torch.as_tensor(batch[k]) for k in cli.STEP_KEYS}
    recorded = []
    state = loop.create_train_state(port, lambda p: _Record(p, recorded))
    ours = loop.make_train_step(cli.make_loss_fn(cfg, port),
                                with_model_state=True)
    out = ours(state, tb, None)
    assert not tq and state.step == 1
    np.testing.assert_allclose(float(out["mse"]), float(metrics["mse"]),
                               rtol=1e-5)

    ref = {k: v.numpy() for k, v in
           weights.from_flax_flat(_flat(grads, "params")).items()}
    (our_grads,) = recorded
    ours_g = {k: g.numpy() for k, g in zip(state.params, our_grads)}
    assert set(ours_g) == set(ref)
    scale = max(float(np.abs(v).max()) for v in ref.values())
    compared = 0
    for k, r in ref.items():
        if max(np.abs(r).max(), np.abs(ours_g[k]).max()) < 5e-2 * scale:
            continue
        np.testing.assert_allclose(ours_g[k] / scale, r / scale, rtol=1e-4,
                                   atol=2e-3, err_msg=k)
        compared += 1
    assert compared >= 40, compared

    after = _bn_buffers(port)
    bn_ref = weights.from_flax_flat(_flat(new_bs, "batch_stats"))
    assert set(after) == set(bn_ref) and len(bn_ref) > 40
    for k, v in after.items():
        np.testing.assert_allclose(v.numpy(), bn_ref[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert all(not m.pending for m in port.modules()
               if isinstance(m, BatchNorm))

    # the port's Adam over all parameters, one global clip, on the JAX
    # gradient (its norm is above the 0.05 clip)
    jg = {k: torch.as_tensor(v) for k, v in ref.items()}
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in
                                jg.values())))
    assert norm > cfg.grad_max_norm
    params = {k: torch.zeros_like(v) for k, v in jg.items()}
    opt = cli.build_optimizer(cfg, list(params.values()))
    opt.step([jg[k] for k in params])
    ref_upd = {k: v.numpy() for k, v in
               weights.from_flax_flat(_flat(upd, "params")).items()}
    top = max(float(np.abs(v).max()) for v in ref_upd.values())
    for k, p in params.items():
        np.testing.assert_allclose(p.numpy(), ref_upd[k], rtol=0,
                                   atol=1e-6 * top, err_msg=k)


class _Record:
    """An optimizer that changes nothing and keeps the gradients."""

    def __init__(self, params, store):
        self.store = store

    def step(self, grads):
        self.store.append([g.clone() for g in grads])


def test_remat_changes_no_bit(multi_scene_root, monkeypatch):
    """The encoder's grid part recomputed in the backward (remat_encoder,
    the preset's default) against kept: the same loss, gradients and
    committed BatchNorm statistics, bit for bit; the grid part runs twice
    with remat (forward, recompute) and once without."""
    from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE
    monkeypatch.setattr(GridEncoder, "plane_hw", (30, 40))
    batch = NeRDS360AE(multi_scene_root, "train", WH, 3, N_RAYS
                       ).sample_train(np.random.default_rng(1))
    tb = {k: torch.as_tensor(batch[k]) for k in cli.STEP_KEYS}
    grid_calls = []
    grid = GridEncoder._grid
    monkeypatch.setattr(GridEncoder, "_grid", lambda self, *a: (
        grid_calls.append(1), grid(self, *a))[1])
    runs = []
    for remat in (True, False):
        cfg = preset("neo360", grid_size=(8, 8, 8), img_wh=WH,
                     remat_encoder=remat, **TINY)
        model = cli.build_model(cfg, "cpu").train()
        assert model.encoder.remat is remat
        recorded = []
        state = loop.create_train_state(model, lambda p: _Record(p,
                                                                  recorded))
        step = loop.make_train_step(cli.make_loss_fn(cfg, model),
                                    with_model_state=True)
        grid_calls.clear()
        metrics = step(state, tb, torch.Generator().manual_seed(4))
        runs.append((metrics, recorded[0], _bn_buffers(model),
                     len(grid_calls)))
    (m_on, g_on, bn_on, calls_on), (m_off, g_off, bn_off, calls_off) = runs
    assert (calls_on, calls_off) == (2, 1)
    assert torch.equal(m_on["mse"], m_off["mse"])
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))
    assert bn_on.keys() == bn_off.keys()
    assert all(torch.equal(bn_on[k], bn_off[k]) for k in bn_on)


def test_weights_carry_the_coarse_level_and_reject_misfits(test_sample):
    """from_flax_flat converts the coarse MLPs and the four local
    projections of the JAX model; load_into raises on an unused key, a
    missing one (a coarse MLP leaf, a "c" projection) and on the weights
    of the proposal model."""
    variables = _init(_jax_model((8, 8, 8)), test_sample)
    sd = weights.from_flax_flat(flax.traverse_util.flatten_dict(variables,
                                                                sep="/"))
    names = {k.split(".")[0] for k in sd}
    assert {"fg_coarse_mlp", "bg_coarse_mlp", "local_proj_fg_c",
            "local_proj_bg_c", "local_proj_fg_f", "local_proj_bg_f"} <= names
    model = _port(variables, (8, 8, 8))
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(KeyError):
        weights.load_into(model, {**sd, "extra.weight": torch.zeros(1)})
    for key in ("bg_coarse_mlp.rgb.bias", "local_proj_fg_c.weight"):
        missing = dict(sd)
        missing.pop(key)
        with pytest.raises(KeyError):
            weights.load_into(model, missing)
    fast = cli.build_model(preset("neo360_fast", bf16=False,
                                  grid_size=(8, 8, 8), encoder_width=64,
                                  lift_dim=None), "cpu")
    with pytest.raises(KeyError):
        weights.load_into(fast, sd)


def test_stage_loss_and_gradients_match_jax(multi_scene_root, monkeypatch,
                                            step_setup):
    """The stage trainer's functions on the neo360 preset (no proposal, one
    scene): the encode's five tables (3 planes, the coarse and the fine
    local table) and BatchNorm update, and one step's loss (l0 + l1 +
    distortion) with its gradient with respect to the ray-branch
    parameters and every table, against the JAX package's
    make_scene_stage_fns (neo360_tpu/models/neo360.py:551-553)."""
    from neo360_tpu.models import neo360 as jneo
    from neo360_tpu_torch.models import neo360
    model, variables, _, draws = step_setup
    stage = JNeRDS360AE(multi_scene_root, "train", WH, 3, N_RAYS
                        ).sample_train_stage(np.random.default_rng(2), 1, 1)
    src = {k: jnp.asarray(stage[k]) for k in SRC}
    batch = {k: jnp.asarray(stage[k][0]) for k in RAYS + ("target",)}
    encode_fn, loss_fn = jneo.make_scene_stage_fns(model)
    enc, ray = jloop.partition_encoder_params(variables["params"])
    (pt, lt), (_, new_bs) = jax.jit(encode_fn)(enc, variables["batch_stats"],
                                               src)
    jq, _ = _shared_uniforms(monkeypatch, draws)
    (loss, _), (g_ray, g_tab) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(ray, (pt, lt), src, batch,
                                                jax.random.PRNGKey(5))
    assert not jq
    ref_tables = list(pt) + [lt["c"], lt["f"]]
    ref_table_grads = list(g_tab[0]) + [g_tab[1]["c"], g_tab[1]["f"]]

    port = _port(variables, (8, 8, 8)).train()
    p_encode, p_loss = neo360.make_scene_stage_fns(port)
    with torch.no_grad():
        tables = p_encode({k: torch.as_tensor(stage[k]) for k in SRC})
    assert len(tables) == 5
    for a, b in zip(tables, ref_tables):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)
    bn_ref = weights.from_flax_flat(_flat(new_bs, "batch_stats"))
    for k, v in _bn_buffers(port).items():
        np.testing.assert_allclose(v.numpy(), bn_ref[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)

    _, tq = _shared_uniforms(monkeypatch, draws)
    leaves = [t.detach().requires_grad_() for t in tables]
    ray_params = {k: v for k, v in port.named_parameters()
                  if not k.startswith(("encoder.", "local_proj"))}
    ours, _ = p_loss(leaves, {k: torch.as_tensor(stage[k]) for k in SRC},
                     {k: torch.as_tensor(stage[k][0])
                      for k in RAYS + ("target",)}, None)
    assert not tq
    np.testing.assert_allclose(float(ours), float(loss), rtol=1e-5)
    grads = torch.autograd.grad(ours, list(ray_params.values()) + leaves)
    ref = {k: v.numpy() for k, v in
           weights.from_flax_flat(_flat(g_ray, "params")).items()}
    ref.update({f"table{i}": np.asarray(g)
                for i, g in enumerate(ref_table_grads)})
    got = dict(zip(list(ray_params) + [f"table{i}" for i in range(5)],
                   (g.numpy() for g in grads)))
    assert set(got) == set(ref)
    scale = max(float(np.abs(v).max()) for v in ref.values())
    for k, r in ref.items():
        np.testing.assert_allclose(got[k] / scale, r / scale, rtol=1e-4,
                                   atol=2e-3, err_msg=k)


def test_stage_accumulates_the_mean_step_gradient(multi_scene_root,
                                                  monkeypatch):
    """A K=2 neo360 stage with float32 accumulators (port only): the
    encoder gradient the stage pulls back from its five accumulated table
    cotangents equals the mean of the two steps' direct encoder gradients
    (same tables, same draws), within 1e-5 of the largest entry (the same
    float32 operations summed in another order)."""
    from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE
    from neo360_tpu_torch.models import neo360
    monkeypatch.setattr(GridEncoder, "plane_hw", (30, 40))
    stage = NeRDS360AE(multi_scene_root, "train", WH, 3, N_RAYS
                       ).sample_train_stage(np.random.default_rng(0), 2, 1)
    port = cli.build_model(preset("neo360", grid_size=(8, 8, 8), **TINY),
                           "cpu").train()
    encode_fn, loss_fn = neo360.make_scene_stage_fns(port)
    src = {k: torch.as_tensor(stage[k]) for k in SRC}
    rays = {k: torch.as_tensor(stage[k]) for k in RAYS + ("target",)}
    recorded = []
    state = loop.create_scene_stage_state(port, lambda p: _Record(p,
                                                                  recorded))
    gen = torch.Generator().manual_seed(5)
    start = gen.get_state()
    loop.make_scene_stage_trainer(encode_fn, loss_fn)(state, src, rays, gen)
    stage_grad = recorded[-1]          # the encoder's one step
    gen.set_state(start)
    enc = list(state.enc_params.values())
    direct = []
    for i in range(2):
        loss, _ = loss_fn(encode_fn(src), src,
                          {k: v[i] for k, v in rays.items()}, gen)
        direct.append(torch.autograd.grad(loss, enc, allow_unused=True))
    mean = [((a if a is not None else 0) + (b if b is not None else 0)) / 2
            for a, b in zip(*direct)]
    scale = max(float(torch.as_tensor(m).abs().max()) for m in mean)
    assert scale > 0
    for name, g, m in zip(state.enc_params, stage_grad, mean):
        np.testing.assert_allclose(g.numpy(), np.broadcast_to(
            np.asarray(m, np.float32), g.shape), rtol=0, atol=1e-5 * scale,
            err_msg=name)
