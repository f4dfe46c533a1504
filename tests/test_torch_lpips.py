"""The port's LPIPS (nn/lpips.py), pretrained-ResNet loader
(nn/resnet.py:load_pretrained) and LPIPS in eval, against the JAX
package on random weights written in the torch layouts (the repository
holds no pretrained weights, and nothing is downloaded).

Tolerances:
- LPIPS, weights from the torch layout and from the npz that
  scripts/convert_weights.py writes: relative error 1e-4 (VGG16's float32
  convolutions sum in another order in the two frameworks).
- The SpatialEncoder with a resnet34 state dict (torch layout or the
  converter's npz) loaded, BatchNorm on the loaded running statistics:
  1e-5 of the largest entry (the random weights' activations reach ~70).
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo360_tpu.nn.lpips import LPIPSModel as JLPIPSModel
from neo360_tpu.nn.resnet import SpatialEncoder as JSpatialEncoder
from neo360_tpu.nn.resnet import convert_torch_state_dict
from neo360_tpu.utils.io import save_variables_npz
from neo360_tpu_torch.nn.lpips import LPIPSModel, random_torch_state
from neo360_tpu_torch.nn.resnet import SpatialEncoder, load_pretrained
from neo360_tpu_torch.train.eval import evaluate_and_save

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import convert_weights  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lpips_files(tmp_path_factory):
    """Random LPIPS weights as a torch state dict and as the converter's
    npz."""
    d = tmp_path_factory.mktemp("lpips")
    pth = str(d / "vgg16_lpips.pth")
    torch.save(random_torch_state(3), pth)
    npz = convert_weights.convert_lpips(pth, str(d / "vgg16_lpips.npz"))
    return pth, npz


@pytest.mark.parametrize("layout", ["pth", "npz"])
def test_lpips_matches_jax(lpips_files, layout):
    """LPIPS of two batches of images against the JAX LPIPSModel."""
    pth, npz = lpips_files
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(2, 32, 48, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(size=x.shape) * 0.2, 0, 1).astype(np.float32)
    ref = np.asarray(JLPIPSModel(pth)(jnp.asarray(x), jnp.asarray(y)))
    model = LPIPSModel(pth if layout == "pth" else npz)
    assert model.pretrained
    assert not any(p.requires_grad for p in model.parameters())
    ours = model(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    assert ours.shape == (2,) and (ours > 0).all()
    np.testing.assert_allclose(ours, ref, rtol=1e-4)


def test_lpips_without_weights_is_not_pretrained(tmp_path):
    """A path that does not exist, or none, leaves random weights and
    pretrained False, as the JAX model does."""
    assert not LPIPSModel(str(tmp_path / "missing.pth")).pretrained
    assert not LPIPSModel().pretrained


def _resnet34_state(seed):
    """A random torchvision resnet34 state dict (its keys and shapes,
    layer4 and fc included)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def bn(name, c):
        sd[f"{name}.weight"] = torch.rand(c, generator=g) + 0.5
        sd[f"{name}.bias"] = torch.randn(c, generator=g) * 0.1
        sd[f"{name}.running_mean"] = torch.randn(c, generator=g) * 0.1
        sd[f"{name}.running_var"] = torch.rand(c, generator=g) + 0.5
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)

    def conv(name, o, i, k):
        sd[name] = torch.randn(o, i, k, k, generator=g) * (2 / (i * k * k)
                                                          ) ** 0.5

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    in_c = 64
    for s, (blocks, width) in enumerate(zip((3, 4, 6, 3),
                                            (64, 128, 256, 512))):
        for b in range(blocks):
            t = f"layer{s + 1}.{b}"
            conv(f"{t}.conv1.weight", width, in_c, 3)
            bn(f"{t}.bn1", width)
            conv(f"{t}.conv2.weight", width, width, 3)
            bn(f"{t}.bn2", width)
            if b == 0 and s > 0:
                conv(f"{t}.downsample.0.weight", width, in_c, 1)
                bn(f"{t}.downsample.1", width)
            in_c = width
    sd["fc.weight"] = torch.randn(1000, 512, generator=g)
    sd["fc.bias"] = torch.randn(1000, generator=g)
    return sd


@pytest.mark.parametrize("layout", ["pth", "npz"])
def test_load_pretrained_matches_jax(tmp_path, layout):
    """A resnet34 state dict (or the converter's npz of it) loaded into
    the SpatialEncoder's backbone: every backbone entry is loaded, and the
    encoder's output with BatchNorm on the loaded running statistics
    matches the JAX SpatialEncoder with the converted variables."""
    sd = _resnet34_state(1)
    pth = str(tmp_path / "resnet34.pth")
    torch.save(sd, pth)
    variables = convert_torch_state_dict({k: v.numpy()
                                          for k, v in sd.items()})
    path = pth if layout == "pth" else save_variables_npz(
        str(tmp_path / "resnet34.npz"), variables)
    enc = SpatialEncoder()
    own = enc.backbone.state_dict()
    loaded = load_pretrained(path)
    assert set(loaded) == set(own)
    enc.backbone.load_state_dict(loaded)
    images = np.random.default_rng(2).uniform(
        -1, 1, size=(2, 30, 40, 3)).astype(np.float32)
    ref = JSpatialEncoder().apply(
        {"params": {"backbone": variables["params"]},
         "batch_stats": {"backbone": variables["batch_stats"]}},
        jnp.asarray(images), False)
    with torch.no_grad():
        ours = enc.eval()(torch.as_tensor(images), False)
    assert ours.shape == (2, 15, 20, 512)
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    with pytest.raises(FileNotFoundError):
        load_pretrained(str(tmp_path / "missing.pth"))


def test_eval_reports_lpips(lpips_files, tmp_path):
    """evaluate_and_save with a pretrained LPIPS model: each view's LPIPS
    (the JAX model's on the same images) in the summary and
    results.json; without one, results.json says LPIPS was skipped."""
    pth, _ = lpips_files
    h, w = 30, 40
    rng = np.random.default_rng(5)
    preds = [rng.uniform(size=(h * w, 3)).astype(np.float32)
             for _ in range(2)]
    samples = [{"target": rng.uniform(size=(h * w, 3)).astype(np.float32)}
               for _ in range(2)]
    outs = iter(preds)

    def render_fn(sample):
        return {"rgb": torch.as_tensor(next(outs))}

    rj = str(tmp_path / "results.json")
    summary = evaluate_and_save(render_fn, samples, (w, h),
                                str(tmp_path / "out"), results_json=rj,
                                lpips_model=LPIPSModel(pth))
    jl = JLPIPSModel(pth)
    ref = [float(jl(jnp.asarray(p.reshape(1, h, w, 3)),
                    jnp.asarray(s["target"].reshape(1, h, w, 3)))[0])
           for p, s in zip(preds, samples)]
    payload = json.load(open(rj))
    np.testing.assert_allclose(payload["lpips"]["views"], ref, rtol=1e-4)
    np.testing.assert_allclose(summary["lpips"], np.mean(ref), rtol=1e-4)
    assert "lpips_status" not in payload

    outs = iter(preds)
    summary = evaluate_and_save(render_fn, samples, (w, h),
                                str(tmp_path / "out2"), results_json=rj)
    assert "lpips" not in summary
    assert json.load(open(rj))["lpips_status"].startswith("skipped")
