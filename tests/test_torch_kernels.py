"""The hand-written CUDA kernels, forward and backward, against their plain
PyTorch versions, and the autograd Functions around them.

Tests marked `cuda` need an NVIDIA GPU with nvcc and skip without one. The
file imports no JAX, so on the GPU machine it runs without the JAX package
and without tests/conftest.py:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Each kernel is compared with its plain version run on the card on the same
tensors (the CPU's exp rounds differently, which can flip a bf16-rounded
softmax weight). Forward tolerances are those of `ops.kernels.compare`:
float32 1e-5 relative, bfloat16 one ulp; each backward's is stated beside
its wrapper (`BACKWARD_TOL`). The CPU tests hold each Function's gradient
against autograd of the plain forward (1e-6: the same float32 operations).
"""

import pytest
import torch

from neo360_tpu_torch.core.render import BACKWARD_TOL as RENDER_BWD_TOL
from neo360_tpu_torch.core.render import OUT_KEYS, composite_nerfpp, \
    composite_nerfpp_backward, composite_nerfpp_reference
from neo360_tpu_torch.ops import kernels
from neo360_tpu_torch.ops.interpolate import BACKWARD_TOL as INTERP_BWD_TOL
from neo360_tpu_torch.ops.interpolate import build_corner_table, \
    table_sample, table_sample_accumulate, \
    table_sample_accumulate_reference, table_sample_backward, \
    table_sample_backward_reference, table_sample_reference
from neo360_tpu_torch.ops.pillar import BACKWARD_TOL as PILLAR_BWD_TOL
from neo360_tpu_torch.ops.pillar import pillar_collapse, \
    pillar_collapse_backward, pillar_collapse_reference


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


# --- backward kernels and the autograd Functions -------------------------

def _composite_args(g, b, s_fg, s_bg):
    fg_t = torch.sort(torch.rand(b, s_fg, generator=g), -1).values
    bg_t = torch.sort(torch.rand(b, s_bg, generator=g), -1,
                      descending=True).values
    return (torch.rand(b, s_fg, 3, generator=g),
            torch.rand(b, s_fg, 1, generator=g) * 10, fg_t,
            torch.rand(b, s_bg, 3, generator=g),
            torch.rand(b, s_bg, 1, generator=g) * 10, bg_t,
            torch.randn(b, 3, generator=g),
            fg_t[:, -1:] + torch.rand(b, 1, generator=g))


def _plain_composite_grads(args, grads, white_bkgd):
    """Autograd of the plain composite on `args`' device."""
    leaves = [a.detach().requires_grad_(i in (0, 1, 3, 4))
              for i, a in enumerate(args)]
    out = composite_nerfpp_reference(*leaves, white_bkgd)
    pairs = [(out[k], g) for k, g in zip(OUT_KEYS, grads) if g is not None]
    return torch.autograd.grad([o for o, _ in pairs],
                               [leaves[i] for i in (0, 1, 3, 4)],
                               [g for _, g in pairs])


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_table_sample_function_grad_matches_plain_autograd(mode):
    """CPU: the Function's table gradient equals autograd of the plain
    forward (an f32 table, finite uv), the flat view offset included."""
    g = _gen(3)
    table = build_corner_table(torch.randn(4, 7, 9, 8, generator=g), mode)
    uv = (torch.rand(2, 60, 2, generator=g) * 2 - 1) * 1.4
    cot = torch.randn(2, 60, 8, generator=g)
    t1 = table.clone().requires_grad_()
    (ours,) = torch.autograd.grad(
        table_sample(t1, uv, (7, 9), mode, view_offset=1), t1, cot)
    t2 = table.clone().requires_grad_()
    (ref,) = torch.autograd.grad(
        table_sample_reference(t2, uv, (7, 9), mode, view_offset=1), t2,
        cot)
    torch.testing.assert_close(ours, ref, rtol=1e-6, atol=1e-6)
    assert ours[0].abs().max() == 0 and ours[3].abs().max() == 0
    assert ours[1].abs().max() > 0


def test_composite_function_grads_match_plain_autograd():
    g = _gen(4)
    args = _composite_args(g, 12, 9, 7)
    leaves = [a.clone().requires_grad_(i in (0, 1, 3, 4))
              for i, a in enumerate(args)]
    out = composite_nerfpp(*leaves, True)
    cots = {k: torch.randn_like(out[k]) for k in OUT_KEYS}
    loss = sum((out[k] * cots[k]).sum() for k in OUT_KEYS)
    ours = torch.autograd.grad(loss, [leaves[i] for i in (0, 1, 3, 4)])
    ref = _plain_composite_grads(args, [cots[k] for k in OUT_KEYS], True)
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_pillar_function_grads_match_plain_autograd():
    g = _gen(5)
    latent = torch.randn(2, 5, 4, 3, 8, generator=g).requires_grad_()
    logits = [torch.randn(2, 5, 4, 3, generator=g).requires_grad_()
              for _ in range(3)]
    cots = [torch.randn(s, generator=g) for s in
            ((2, 4, 3, 8), (2, 5, 3, 8), (2, 5, 4, 8))]
    ours = torch.autograd.grad(pillar_collapse(latent, *logits),
                               [latent, *logits], cots)
    ref = torch.autograd.grad(pillar_collapse_reference(latent, *logits),
                              [latent, *logits], cots)
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_functions_refuse_gradients_they_do_not_give():
    g = _gen(6)
    table = torch.randn(1, 5, 5, 16, generator=g, requires_grad=True)
    uv = torch.rand(1, 4, 2, generator=g, requires_grad=True)
    with pytest.raises(ValueError, match="uv takes no gradient"):
        table_sample(table, uv, (4, 4))
    args = list(_composite_args(g, 4, 5, 5))
    for i, name in ((2, "fg_t"), (5, "bg_t"), (6, "dirs"), (7, "far")):
        bad = list(args)
        bad[i] = bad[i].clone().requires_grad_()
        with pytest.raises(ValueError, match=name):
            composite_nerfpp(*bad)
    with torch.no_grad():      # no autograd: no Function, no check
        table_sample(table, uv, (4, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype,grad_dtype", [
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float32)])
@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_table_sample_backward_kernel(cuda, table_dtype, grad_dtype, mode):
    g = _gen(7)
    h, w, c = 15, 20, 32
    shape = (6, h + 1, w + 1, 4 * c)
    uv = _uv(3, 2000, g)
    cot = torch.randn(3, 2000, c, generator=g).to(grad_dtype)
    uv, cot = uv.to(cuda), cot.to(cuda)
    for offset in (0, 3):
        ref = table_sample_backward_reference(cot, uv, shape, table_dtype,
                                              (h, w), mode, offset)
        before = table_sample_backward.launches
        out = table_sample_backward(cot, uv, shape, table_dtype, (h, w),
                                    mode, offset)
        assert table_sample_backward.launches == before + 1
        res = kernels.compare(out, ref, **INTERP_BWD_TOL)
        assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("s_fg,s_bg", [(65, 65), (61, 61), (9, 5)])
def test_composite_backward_kernel(cuda, white_bkgd, subset, s_fg, s_bg):
    g = _gen(8)
    args = tuple(a.to(cuda) for a in _composite_args(g, 300, s_fg, s_bg))
    ref_out = composite_nerfpp_reference(*args, white_bkgd)
    grads = [torch.randn(ref_out[k].shape, generator=g).to(cuda)
             if not subset or k in ("rgb", "fg_weights", "bg_weights")
             else None for k in OUT_KEYS]
    ref = _plain_composite_grads(args, grads, white_bkgd)
    before = composite_nerfpp_backward.launches
    out = composite_nerfpp_backward(args, grads, white_bkgd)
    assert composite_nerfpp_backward.launches == before + 1
    for o, r in zip(out, ref):
        res = kernels.compare(o, r, **RENDER_BWD_TOL)
        assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 6, 4, 40), (3, 16, 16, 8, 512)])
def test_pillar_collapse_backward_kernel(cuda, dtype, shape):
    g = _gen(9)
    nv, x, y, z, c = shape
    args = [torch.randn(shape, generator=g).to(dtype).to(cuda)] + [
        (torch.randn(nv, x, y, z, generator=g) * 3).to(dtype).to(cuda)
        for _ in range(3)]
    cots = [torch.randn(s, generator=g).to(dtype).to(cuda) for s in
            ((nv, y, z, c), (nv, x, z, c), (nv, x, y, c))]
    leaves = [a.detach().requires_grad_() for a in args]
    ref = torch.autograd.grad(pillar_collapse_reference(*leaves), leaves,
                              cots)
    before = pillar_collapse_backward.launches
    out = pillar_collapse_backward(args, cots)
    assert pillar_collapse_backward.launches == before + 1
    res = kernels.compare(out[0], ref[0], **PILLAR_BWD_TOL["latent"])
    assert res["ok"], res
    for o, r in zip(out[1:], ref[1:]):
        res = kernels.compare(o, r, **PILLAR_BWD_TOL["logit"][dtype])
        assert res["ok"], res


@pytest.mark.cuda
def test_gradients_reach_inputs_through_kernels(cuda):
    """On the card the Functions launch the forward and backward kernels
    and their gradients match the plain version's autograd."""
    g = _gen(10)
    table = build_corner_table(torch.randn(3, 15, 20, 32, generator=g),
                               "zeros").to(cuda).requires_grad_()
    uv = _uv(3, 500, g).nan_to_num(0.0, 0.0, 0.0).to(cuda)
    cot = torch.randn(3, 500, 32, generator=g).to(cuda)
    before = (table_sample.launches, table_sample_backward.launches)
    (ours,) = torch.autograd.grad(table_sample(table, uv, (15, 20)), table,
                                  cot)
    assert (table_sample.launches, table_sample_backward.launches) == (
        before[0] + 1, before[1] + 1)
    (ref,) = torch.autograd.grad(table_sample_reference(table, uv, (15, 20)),
                                 table, cot)
    res = kernels.compare(ours, ref, **INTERP_BWD_TOL)
    assert res["ok"], res


# --- A' under the accumulate contract, and B at chunk edges --------------

def _ray_uv(b, n_rays, s, g, lim=1.2, reach=0.3):
    """uv of `s` consecutive samples along each of `n_rays` short segments
    per view, as the fine level gives them (consecutive points often read
    one row); the first five points are huge or non-finite."""
    start = (torch.rand(b, n_rays, 1, 2, generator=g) * 2 - 1) * lim
    step = torch.randn(b, n_rays, 1, 2, generator=g) * reach
    t = torch.sort(torch.rand(b, n_rays, s, 1, generator=g), 2).values
    uv = (start + t * step).reshape(b, n_rays * s, 2)
    uv[0, :5] = torch.tensor([[1e30, 0.0], [-1e30, 0.5], [float("inf"), 0.0],
                              [0.0, float("nan")], [-1.0, -1.0]])
    return uv


@pytest.mark.parametrize("nonfinite", [False, True])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("view_offset", [0, 3])
@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_accumulate_reference_sums_the_dense_gradients(mode, view_offset,
                                                       grad_dtype, nonfinite):
    """CPU: three accumulate calls into one f32 accumulator equal the sum
    of the dense plain version's three f32 gradients (1e-6: the same f32
    products, summed in another order); non-finite uv adds nothing."""
    g = _gen(11)
    h, w, c = 7, 9, 8
    shape = (6, h + 1, w + 1, 4 * c)
    acc = torch.zeros(shape)
    dense = torch.zeros(shape)
    before = table_sample_accumulate.launches
    for _ in range(3):
        uv = (_uv(3, 50, g, 1.4) if nonfinite
              else (torch.rand(3, 50, 2, generator=g) * 2 - 1) * 1.4)
        cot = torch.randn(3, 50, c, generator=g).to(grad_dtype)
        table_sample_accumulate(cot, uv, acc, (h, w), mode, view_offset)
        dense += table_sample_backward_reference(cot, uv, shape,
                                                 torch.float32, (h, w), mode,
                                                 view_offset)
    assert table_sample_accumulate.launches == before   # no kernel on CPU
    torch.testing.assert_close(acc, dense, rtol=1e-6, atol=1e-6)
    assert acc.abs().max() > 0
    read = set(range(view_offset, view_offset + 3))
    for v in range(shape[0]):
        assert (acc[v].abs().max() > 0) == (v in read), v
    if nonfinite:   # non-finite points add nothing
        alone = torch.zeros(shape)
        uv = torch.tensor([[[float("inf"), 0.0], [0.0, float("nan")],
                            [-float("inf"), 1.0]]])
        table_sample_accumulate(torch.ones(1, 3, c), uv, alone, (h, w), mode,
                                view_offset)
        assert alone.abs().max() == 0


def test_table_sample_function_adds_into_grad_acc():
    """CPU: with grad_acc the Function's backward adds the table gradient
    into the accumulator and autograd gets None for the table; the sum over
    two calls equals the sum of autograd of the plain forward (1e-6)."""
    g = _gen(12)
    table = build_corner_table(torch.randn(4, 7, 9, 8, generator=g),
                               "zeros").requires_grad_()
    acc = torch.zeros(table.shape)
    ref = torch.zeros(table.shape)
    for _ in range(2):
        uv = (torch.rand(2, 60, 2, generator=g) * 2 - 1) * 1.4
        cot = torch.randn(2, 60, 8, generator=g)
        out = table_sample(table, uv, (7, 9), "zeros", view_offset=1,
                           grad_acc=acc)
        (ours,) = torch.autograd.grad(out, table, cot, allow_unused=True)
        assert ours is None
        ref += torch.autograd.grad(
            table_sample_reference(table, uv, (7, 9), "zeros",
                                   view_offset=1), table, cot)[0]
    torch.testing.assert_close(acc, ref, rtol=1e-6, atol=1e-6)
    assert acc[1:3].abs().max() > 0
    for bad in (torch.zeros(table.shape, dtype=torch.float64),
                torch.zeros(table.shape[:-1] + (4,))):
        with pytest.raises(ValueError, match="grad_acc"):
            table_sample(table, uv, (7, 9), grad_acc=bad)


# A' accumulate cases: (table shape, hw, mode, view offsets of the calls,
# uv of each call (views, rays, samples per ray)); "path" is one stage
# step's tri-plane (6 flat views, scene 1 at 3) and local (12, scene 1 at
# 6) calls, 250 rays x 61 samples, fg + bg
ACC_CASES = {
    "small zeros": ((6, 16, 21, 128), (15, 20), "zeros", (0, 3),
                    (3, 40, 50)),
    "small border": ((6, 16, 21, 128), (15, 20), "border", (0, 3),
                     (3, 40, 50)),
    "path plane": ((6, 121, 161, 512), (120, 160), "zeros", (0, 3),
                   (3, 500, 61)),
    "path local": ((12, 121, 161, 512), (120, 160), "border", (0, 6),
                   (6, 250, 61)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(ACC_CASES))
def test_table_sample_accumulate_kernel(cuda, case, grad_dtype):
    """Two scenes' calls into one accumulator on the card against the
    index_add_ plain version, with runs of points that read one row."""
    shape, hw, mode, offsets, (b, rays, s) = ACC_CASES[case]
    g = _gen(13)
    acc = torch.zeros(shape, device=cuda)
    ref = torch.zeros(shape, device=cuda)
    before = table_sample_accumulate.launches
    for off in offsets:
        uv = _ray_uv(b, rays, s, g).to(cuda)
        cot = torch.randn(b, rays * s, shape[-1] // 4, generator=g).to(
            grad_dtype).to(cuda)
        table_sample_accumulate(cot, uv, acc, hw, mode, off)
        table_sample_accumulate_reference(cot, uv, ref, hw, mode, off)
    assert table_sample_accumulate.launches == before + len(offsets)
    res = kernels.compare(acc, ref, **INTERP_BWD_TOL)
    assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_table_sample_backward_kernel_path_shapes(cuda, mode):
    """The dense contract at the grid lift's shape (3 x 131,072 points,
    bf16 cotangent and table) and ray-structured uv."""
    g = _gen(14)
    shape = (3, 121, 161, 512)
    uv = _ray_uv(3, 4096, 32, g, lim=1.5).to(cuda)
    cot = torch.randn(3, 4096 * 32, 128, generator=g).to(
        torch.bfloat16).to(cuda)
    ref = table_sample_backward_reference(cot, uv, shape, torch.bfloat16,
                                          (120, 160), mode)
    out = table_sample_backward(cot, uv, shape, torch.bfloat16, (120, 160),
                                mode)
    res = kernels.compare(out, ref, **INTERP_BWD_TOL)
    assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("b,s_fg,s_bg", [
    (7, 1, 1), (33, 32, 33), (33, 33, 32), (5, 64, 1), (1, 97, 31),
    (256, 65, 65), (256, 61, 61)])
def test_composite_kernel_chunk_edges(cuda, b, s_fg, s_bg):
    """Kernel B (one warp per ray, 32-sample chunks) at sample counts on
    and around the chunk edges and at the path's 256-ray tiles."""
    g = _gen(15)
    args = tuple(a.to(cuda) for a in _composite_args(g, b, s_fg, s_bg))
    for white_bkgd in (False, True):
        ref = composite_nerfpp_reference(*args, white_bkgd)
        out = composite_nerfpp(*args, white_bkgd)
        for k in ref:
            _assert_ok(out[k], ref[k])
