"""The hand-written CUDA kernels against their plain PyTorch versions.

Tests marked `cuda` need an NVIDIA GPU with nvcc and skip without one. The
file imports no JAX, so on the GPU machine it runs without the JAX package
and without tests/conftest.py:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Each kernel is compared with its plain version run on the card on the same
tensors (the CPU's exp rounds differently, which can flip a bf16-rounded
softmax weight). Tolerances are those of `ops.kernels.compare`: float32
1e-5 relative, bfloat16 one ulp.
"""

import pytest
import torch

from neo360_tpu_torch.core.render import composite_nerfpp, \
    composite_nerfpp_reference
from neo360_tpu_torch.ops import kernels
from neo360_tpu_torch.ops.interpolate import table_sample, \
    table_sample_reference
from neo360_tpu_torch.ops.pillar import pillar_collapse, \
    pillar_collapse_reference


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _uv(b, n, g, lim=1.3):
    uv = (torch.rand(b, n, 2, generator=g) * 2 - 1) * lim
    uv[0, :5] = torch.tensor([[1e30, 0.0], [-1e30, 0.5], [float("inf"), 0.0],
                              [0.0, float("nan")], [-1.0, -1.0]])
    return uv


def _assert_ok(out, ref):
    res = kernels.compare(out, ref)
    assert res["ok"], res


def test_compare_tolerances():
    ref = torch.tensor([1.0, 3.0, -0.5])
    assert kernels.compare(ref * (1 + 5e-6), ref)["ok"]
    assert not kernels.compare(ref * (1 + 1e-4), ref)["ok"]
    rb = ref.to(torch.bfloat16)
    one_ulp = torch.tensor([1.0078125, 3.015625, -0.50195312]).to(
        torch.bfloat16)
    assert kernels.compare(one_ulp, rb)["ok"]
    two_ulp = torch.tensor([1.015625, 3.03125, -0.50390625]).to(torch.bfloat16)
    assert not kernels.compare(two_ulp, rb)["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_table_sample_kernel(cuda, table_dtype, out_dtype, mode):
    g = _gen(0)
    h, w, c = 15, 20, 32
    table = torch.randn(6, h + 1, w + 1, 4 * c, generator=g).to(table_dtype)
    uv = _uv(3, 1000, g)
    if mode == "border":
        uv = uv.nan_to_num(0.0, 0.0, 0.0)
    table, uv = table.to(cuda), uv.to(cuda)
    for offset in (0, 3, 7):
        ref = table_sample_reference(table, uv, (h, w), mode, out_dtype,
                                     offset)
        before = table_sample.launches
        out = table_sample(table, uv, (h, w), mode, out_dtype, offset)
        assert table_sample.launches == before + 1
        _assert_ok(out, ref)


@pytest.mark.cuda
def test_table_sample_kernel_rejects_bad_inputs(cuda):
    table = torch.zeros(1, 5, 5, 4 * 12, dtype=torch.bfloat16, device=cuda)
    uv = torch.zeros(1, 4, 2, device=cuda)
    with pytest.raises(ValueError):   # C=12 is not a multiple of 8
        table_sample(table, uv, (4, 4))
    with pytest.raises(ValueError):   # table does not fit hw
        table_sample(torch.zeros(1, 5, 5, 32, device=cuda), uv, (3, 3))
    with pytest.raises(ValueError):   # uv must be float32
        table_sample(torch.zeros(1, 5, 5, 32, device=cuda), uv.double(),
                     (4, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("s_fg,s_bg", [(65, 65), (61, 61), (9, 5)])
def test_composite_kernel(cuda, white_bkgd, s_fg, s_bg):
    g = _gen(1)
    b = 300
    fg_t = torch.sort(torch.rand(b, s_fg, generator=g), -1).values
    bg_t = torch.sort(torch.rand(b, s_bg, generator=g), -1,
                      descending=True).values
    args = (torch.rand(b, s_fg, 3, generator=g),
            torch.rand(b, s_fg, 1, generator=g) * 10, fg_t,
            torch.rand(b, s_bg, 3, generator=g),
            torch.rand(b, s_bg, 1, generator=g) * 10, bg_t,
            torch.randn(b, 3, generator=g),
            fg_t[:, -1:] + torch.rand(b, 1, generator=g))
    args = tuple(a.to(cuda) for a in args)
    ref = composite_nerfpp_reference(*args, white_bkgd)
    before = composite_nerfpp.launches
    out = composite_nerfpp(*args, white_bkgd)
    assert composite_nerfpp.launches == before + 1
    assert set(out) == set(ref)
    for k in ref:
        _assert_ok(out[k], ref[k])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 8, 6, 4, 40), (3, 16, 16, 8, 512)])
def test_pillar_collapse_kernel(cuda, dtype, shape):
    g = _gen(2)
    nv, x, y, z, c = shape
    latent = torch.randn(shape, generator=g).to(dtype).to(cuda)
    logits = [(torch.randn(nv, x, y, z, generator=g) * 3).to(dtype).to(cuda)
              for _ in range(3)]
    ref = pillar_collapse_reference(latent, *logits)
    before = pillar_collapse.launches
    out = pillar_collapse(latent, *logits)
    assert pillar_collapse.launches == before + 1
    for o, r in zip(out, ref):
        _assert_ok(o, r)
