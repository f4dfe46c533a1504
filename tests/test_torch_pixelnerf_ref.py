"""The port's published PixelNeRF on its plain path (the CPU) against the
benchmark's plain reference (benchmark/reference/pixelnerf.py), on the
benchmark's seeded weights and items of its `pixelnerf_step` mix, at the
adapter's tiny sizes (benchmark/architectures/pixelnerf.py TINY: a 5 x 32
ResnetFC, 8 + 4 + 4 samples, 2 scenes x 3 views x 8 rays at 40x30),
float32. Both sides draw from generators seeded alike, in the published
order. The seed is one where neither level's density head starts dead
(with the benchmark's weights a level can start with ReLU density 0 at
every sample, and then has no gradient to compare).

Tolerances:
- each level's colour, weights and depth: 1e-5 relative plus 5e-5
  absolute. The sides sample the latent differently (a corner table and
  a bmm fold against `F.grid_sample`), encode the scenes' images in
  another order (BatchNorm's sums), and composite with and without the
  |direction| factor, 1 to rounding (measured: at most 7.9e-6).
- the loss: 1e-6 relative (measured: equal bits); each parameter's
  gradient, the ResnetFCs' included: 1e-4 of the largest entry of that
  parameter's gradient, as tests/test_torch_mipnerf360_ref.py holds them
  (measured: at most 9.3e-6).
- three Adam steps, the harness's own numbers (benchmark/check.py): the
  first step's loss 1e-5 relative (measured: 0); the first moments 1e-3
  and the change 0.05 (measured: 2.9e-6 and 1.3e-3; 2.3e-4 and 7.5e-3
  with the generator seeded 11). Adam's first step
  moves every entry by the learning rate times the sign of its gradient,
  so an entry whose gradient is rounding-sized (the encoder's BatchNorm
  scales and shifts, whose gradients the next BatchNorm nearly cancels)
  moves by +-lr on either side.
The reference with its "combine" fault (the views averaged one block
late) misses them by orders of magnitude.
"""

import pytest
import torch

from benchmark import check, weights
from benchmark.architectures import pixelnerf as adapter
from benchmark.reference import pixelnerf as ref
from benchmark.registry import Registry
from neo360_tpu_torch import cli

torch.set_num_threads(1)

SEED = 5
GEN = 9
RTOL, ATOL = 1e-5, 5e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    """(the port's program at the tiny sizes with the seeded weights, its
    trained weights, the configuration, three items)."""
    reg = Registry()
    config = reg.config("pixelnerf")
    with adapter.tiny(config) as over:
        config = dict(config, **over)
        prog = adapter.Program(config, SEED, torch.device("cpu"), GEN)
    mix = dict(reg.traffic("pixelnerf_step"), img_wh=config["img_wh"],
               items_in_pool=3)
    w = weights.make(prog.shapes(), SEED, "cpu")
    prog.load(w)
    trained = {k: w[k] for k in prog.trained_names()}
    items = adapter.make_items(mix, SEED, "cpu", prog.cfg)["items"]
    return prog, trained, config, items


def _gen():
    return torch.Generator().manual_seed(GEN)


def _arch(config):
    return ref.Arch.from_config(config)


def test_the_items_are_steps_of_scenes(setup):
    _, _, config, items = setup
    s, r = config["scenes_per_step"], config["rays_per_scene"]
    assert items[0]["src_imgs"].shape == (s, 3, 30, 40, 3)
    assert items[0]["rays_o"].shape == (s, r, 3)


def test_every_level_matches_the_reference(setup):
    prog, trained, config, items = setup
    model, item = prog.model.train(), items[0]
    rays = {k: item[k] for k in cli.RAY_KEYS + cli.SRC_KEYS}
    with torch.no_grad():
        got = model(rays, model.encode(item["src_imgs"], True), False, True,
                    _gen())
        want = ref.render(trained, ref.ref_model.Precision(), _arch(config),
                          {k: item[k] for k in ref.SRC_KEYS}, item, _gen())
    for level, (out, (rgb, w, depth)) in enumerate(zip(got, want)):
        assert out["acc"].max() > 0.5, level           # a live level
        for k, value in (("rgb", rgb), ("weights", w), ("depth", depth)):
            assert torch.allclose(out[k].reshape(value.shape), value,
                                  rtol=RTOL, atol=ATOL), (level, k)


def test_the_loss_and_every_gradient_match_the_reference(setup):
    prog, trained, config, items = setup
    model, item = prog.model.train(), items[0]
    names = list(trained)
    params = dict(model.named_parameters())
    loss, _ = cli.make_loss_fn(prog.cfg, model)(
        {k: item[k] for k in cli.STEP_KEYS}, _gen())
    got = torch.autograd.grad(loss, [params[k] for k in names])
    tr = ref.Trainer(_arch(config), trained)
    want_loss = tr.loss(item, _gen())
    want = torch.autograd.grad(want_loss, [tr.W[k] for k in names])
    assert float(loss.detach()) == pytest.approx(float(want_loss.detach()),
                                                 rel=1e-6)
    resnetfc = 0
    for name, a, b in zip(names, got, want):
        top = float(b.abs().max())
        assert float((a - b).abs().max()) <= GRAD_TOL * top, name
        resnetfc += "_mlp." in name and top > 0
    assert resnetfc == 2 * (2 + 2 * 3 + 4 * 5 + 2)   # every ResnetFC leaf


def _steps(setup, fault=None):
    """The harness's numbers of three steps: the program's against the
    reference (or the faulty reference in the program's place)."""
    prog, trained, config, items = setup
    ref_out = adapter.reference_train(config, trained, "per_step",
                                      items[:3], GEN, "cpu")
    if fault is not None:
        return check.train_numbers(adapter.reference_train(
            config, trained, "per_step", items[:3], GEN, "cpu",
            fault=fault), ref_out)[0]
    w0 = {k: v.clone() for k, v in trained.items()}
    prog.make_trainer()
    prog.generator = _gen()
    prog.recording = True
    for i, item in enumerate(items[:3]):
        prog.runner(item)
        if i == 0:
            moments = check.norms(prog.moments())
    params = prog.params()
    got = {"losses": [float(x) for x in prog.recorded], "moments": moments,
           "change": check.norms({k: params[k] - w0[k] for k in w0})}
    prog.load({**dict(prog.model.state_dict()), **w0})
    return check.train_numbers(got, ref_out)[0]


def test_three_steps_match_and_the_combine_fault_does_not(setup):
    good = _steps(setup)
    assert good["loss_gap_first"] <= 1e-5, good
    assert good["moment_gap"] <= 1e-3, good
    assert good["change_gap"] <= 0.05, good
    bad = _steps(setup, "combine")
    assert bad["loss_gap_first"] > 100 * 1e-5, bad
    assert bad["moment_gap"] > 10 * 1e-3, bad
