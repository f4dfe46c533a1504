"""The port's MipNeRF-360 on its plain path (the CPU) against the
benchmark's plain reference (benchmark/reference/mipnerf360.py), on the
benchmark's seeded weights and a "rays" mix of its synthetic scene, at a
tiny size: NeRF MLP 8 x 32, proposal MLPs 2 x 32, 8 + 8 + 4 samples, 32
rays of a 40x30 scene, float32. Both sides draw their jitter from
generators seeded alike, in the order the program draws it (per level).

Tolerances:
- Each level's edges, weights, densities and colours, the loss, and the
  parameters after two Adam steps: 1e-5 relative plus 1e-6 absolute. The
  two sides compute the contraction's Jacobian (closed form against
  forward-mode autodiff), the lifted variances (a matmul against an
  einsum) and the distortion (O(S) against O(S^2)) in another order;
  the edges feed every later level, so a rounding there moves the rest
  (measured: at most 1.1e-6 absolute, 1.2e-7 relative beyond 1e-6).
- Each parameter's gradient: 1e-4 of the largest entry of that
  parameter's gradient, as tests/test_torch_train.py holds gradients
  (float32 conditioning of a sum over 32 rays x 20 intervals; measured:
  at most 2.4e-6).
- The basis: equal bits (both are float32 casts of the same float64
  vertices).
The reference with its "jacobian" fault (covariances not pushed through
the contraction's Jacobian) misses these tolerances by orders of
magnitude.
"""

import numpy as np
import pytest
import torch

from benchmark import scenes, weights
from benchmark.reference import mipnerf360 as ref
from neo360_tpu_torch import cli
from neo360_tpu_torch.config import preset
from neo360_tpu_torch.core import encoding
from neo360_tpu_torch.models.mipnerf360 import MipNeRF360
from neo360_tpu_torch.train import loop

torch.set_num_threads(1)

SIZES = dict(num_prop_samples=8, num_nerf_samples=4, nerf_netwidth=32,
             prop_netdepth=2, prop_netwidth=32)
ARCH = ref.Arch(**SIZES, near=cli.SCENE_NEAR, far=cli.SCENE_FAR)
MIX = {"name": "t", "kind": "rays", "img_wh": [40, 30], "scenes_in_pool": 1,
       "train_views_per_scene": 12, "camera_radius": 8.0, "items_in_pool": 2}
N_RAYS = 32
SEED = 3_000_000_019
RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-4


def _close(a, b, rtol=RTOL, atol=ATOL):
    return torch.allclose(a, b, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def setup():
    """(the port's model with the seeded weights, the weights, two items
    of rays with their targets and radii)."""
    model = MipNeRF360(**SIZES)
    w = weights.make({k: tuple(v.shape)
                      for k, v in model.state_dict().items()}, SEED, "cpu")
    model.load_state_dict(w, strict=True)
    items = scenes.make_items(MIX, SEED, "cpu", 0,
                              rays_per_step=N_RAYS)["items"]
    return model, w, items


def _gen():
    return torch.Generator().manual_seed(7)


def _rays(item):
    return {k: item[k] for k in cli.MIP_RAY_KEYS}


def _reference(w, item, frac, fault=None):
    basis = torch.as_tensor(ref.basis(ARCH.basis_tesselation))
    return ref.render(w, ARCH, _rays(item), frac, _gen(), basis, fault)


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_every_level_matches_the_reference(setup, frac):
    """Edges, weights, densities and colours of the two proposal levels
    and the NeRF level, and the rendered colour, at train_frac 0 (the
    first step: no anneal), 0.3 and 1."""
    model, w, items = setup
    with torch.no_grad():
        rend, hist = model(_rays(items[0]), frac, True, cli.SCENE_NEAR,
                           cli.SCENE_FAR, generator=_gen())
        rgb, ref_hist = _reference(w, items[0], frac)
    assert len(hist) == len(ref_hist) == 3
    for level, (got, want) in enumerate(zip(hist, ref_hist)):
        for k in ("sdist", "weights", "density"):
            assert _close(got[k], want[k]), (level, k)
        if want["rgb"] is None:         # the proposals render no colour
            assert not got["rgb"].any()
        else:
            assert _close(got["rgb"], want["rgb"]), level
    assert _close(rend[-1]["rgb"], rgb)


def test_the_jacobian_fault_misses_the_tolerances(setup):
    model, w, items = setup
    with torch.no_grad():
        _, hist = model(_rays(items[0]), 0.0, True, cli.SCENE_NEAR,
                        cli.SCENE_FAR, generator=_gen())
        _, faulty = _reference(w, items[0], 0.0, "jacobian")
    for k in ("density", "rgb"):
        gap = (hist[-1][k] - faulty[-1][k]).abs().max()
        assert gap > 100 * (ATOL + RTOL * faulty[-1][k].abs().max()), k


def _port_loss_and_grads(model, item, step):
    cfg = preset("mipnerf360", device="cpu", batch_size=N_RAYS,
                 num_prop_samples=8, num_fine_samples=4)
    loss_fn = cli.make_loss_fn(cfg, model)
    params = dict(model.named_parameters())
    loss, _ = loss_fn({k: item[k] for k in cli.MIP_RAY_KEYS + ("target",)},
                      _gen(), step)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, dict(zip(params, grads))


@pytest.mark.parametrize("step", [0, 300_000])
def test_loss_and_every_gradient_match_the_reference(setup, step):
    """The loss (data term, interlevel, 0.01 x distortion) at the step's
    anneal, and the gradient of every parameter."""
    model, w, items = setup
    loss, grads = _port_loss_and_grads(model, items[1], step)
    tr = ref.Trainer(ARCH, w)
    tr.count = step
    want = tr.loss({k: items[1][k] for k in ref.KEYS}, _gen())
    want_grads = torch.autograd.grad(want, list(tr.W.values()))
    assert _close(loss, want)
    assert set(grads) == set(tr.W)
    for (name, g), wg in zip(tr.W.items(), want_grads):
        scale = float(wg.abs().max())
        assert scale > 0, name
        assert float((grads[name] - wg).abs().max()) <= GRAD_TOL * scale, \
            name


def test_adam_steps_match_the_reference(setup):
    """The port's training step (make_train_step on the CLI's loss and
    optimizer) and the reference's, from the same weights, one step an
    item: each step's loss and every parameter after the last."""
    _, w, items = setup
    model = MipNeRF360(**SIZES)
    model.load_state_dict(w, strict=True)
    model.train()
    cfg = preset("mipnerf360", device="cpu", batch_size=N_RAYS,
                 num_prop_samples=8, num_fine_samples=4)
    state = loop.create_train_state(
        model, lambda params: cli.build_optimizer(cfg, params))
    step = loop.make_train_step(cli.make_loss_fn(cfg, model),
                                with_step=True)
    tr = ref.Trainer(ARCH, w)
    for item in items:
        got = step(state, {k: item[k] for k in cli.MIP_RAY_KEYS
                           + ("target",)}, _gen())
        want = tr.step({k: item[k] for k in ref.KEYS}, _gen())
        assert float(got["loss"]) == pytest.approx(want, rel=RTOL)
    for name, p in tr.params().items():
        moved = state.params[name].detach()
        assert not torch.equal(moved, w[name]), name
        assert _close(moved, p), name


@pytest.mark.parametrize("tesselation", [1, 2, 3, 4])
def test_the_references_basis_is_the_ports(tesselation):
    got = ref.basis(tesselation)
    want = encoding.generate_basis("icosahedron", tesselation)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
