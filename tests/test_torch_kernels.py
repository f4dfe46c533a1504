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

import importlib.util

import pytest
import torch

from neo360_tpu_torch.core.render import BACKWARD_TOL as RENDER_BWD_TOL
from neo360_tpu_torch.core.render import MIP_BACKWARD_TOL, MIP_OUT_KEYS, \
    OUT_KEYS, VANILLA_OUT_KEYS, composite_mip, composite_mip_backward, \
    composite_mip_reference, composite_nerfpp, composite_nerfpp_backward, \
    composite_nerfpp_reference, composite_vanilla, \
    composite_vanilla_backward, composite_vanilla_reference
from neo360_tpu_torch.ops import kernels
from neo360_tpu_torch.ops.interpolate import BACKWARD_TOL as INTERP_BWD_TOL
from neo360_tpu_torch.ops.interpolate import FUSED_TOL, \
    GRID_SAMPLE_BF16_GRAD_TOL, GRID_SAMPLE_TOL, build_corner_table, \
    grid_sample_2d, grid_sample_2d_backward, \
    grid_sample_2d_backward_reference, grid_sample_2d_reference, \
    local_sample, local_sample_reference, local_uv, table_sample, \
    table_sample_accumulate, table_sample_accumulate_reference, \
    table_sample_backward, table_sample_backward_reference, \
    table_sample_reference, triplane_sample, triplane_sample_reference, \
    triplane_uvs
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


def test_launches_count_each_entry_and_no_cpu_call():
    """`kernels.launches` holds every C entry at 0 when the module is
    imported, and a call of each wrapper on CPU tensors (its plain
    version, forward and backward) counts no launch."""
    spec = importlib.util.find_spec(kernels.__name__)
    fresh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fresh)
    assert fresh.launches == dict.fromkeys(fresh.SIGNATURES, 0)
    assert set(kernels.launches) == set(kernels.SIGNATURES)
    before = dict(kernels.launches)
    g = _gen(60)
    hw = (5, 6)
    tables = [build_corner_table(torch.randn(6, *hw, 8, generator=g),
                                 mode).requires_grad_()
              for mode in ("zeros", "zeros", "zeros", "border")]
    uv = (torch.rand(6, 10, 2, generator=g) * 2 - 1) * 1.2
    cam = _ray_cam(3, 4, 2, g)
    acc = torch.zeros(tables[0].shape)
    image = torch.randn(2, *hw, 3, generator=g).requires_grad_()
    latent = torch.randn(2, 5, 4, 3, 8, generator=g).requires_grad_()
    logits = [torch.randn(2, 5, 4, 3, generator=g).requires_grad_()
              for _ in range(3)]

    def leaves(args, wrt):
        return [a.clone().requires_grad_(i in wrt)
                for i, a in enumerate(args)]

    outs = [table_sample(tables[0], uv, hw),                        # A, A'
            table_sample(tables[0], uv, hw, grad_acc=acc),          # A' acc
            triplane_sample(tables[:3], cam, hw),
            local_sample(tables[3], cam, FOCAL, CENTRE, SCALE, hw),
            grid_sample_2d(image, uv[:2]),                          # G, G'
            composite_nerfpp(*leaves(_composite_args(g, 4, 5, 3),
                                     (0, 1, 3, 4)))["rgb"],         # B, B'
            composite_vanilla(*leaves(_vanilla_args(g, 4, 5), (0, 1)))[0],
            composite_mip(*leaves(_mip_args(g, 4, 5), (0, 3)))[1],  # E, E'
            *pillar_collapse(latent, *logits)]                      # C, C'
    sum(o.sum() for o in outs).backward()
    assert kernels.launches == before


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
        before = kernels.launches["table_sample_fwd"]
        out = table_sample(table, uv, (h, w), mode, out_dtype, offset)
        assert kernels.launches["table_sample_fwd"] == before + 1
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


def _same_values(out, ref):
    """Equal values (+0 and -0 alike), NaN where `ref` has NaN."""
    torch.testing.assert_close(out, ref, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("c", [1, 3, 32, 512, 1100])
def test_grid_sample_2d_kernel(cuda, dtype, mode, c):
    """grid_sample_2d on the card (kernel G, its image gradient kernel G')
    against its plain four-corner version: exactly one launch of each a
    call whatever C, and no corner-table launch. The forward repeats the
    plain version's arithmetic: equal values for an image of finite
    values (the only kind made here; see
    test_grid_sample_2d_kernel_non_finite_edge_pixel), NaN where it has
    NaN (border mode at a NaN point). The gradient: GRID_SAMPLE_TOL for an f32 image;
    for a bf16 one, one bf16 rounding of the f32 plain gradient, and one
    bf16 ulp of the plain version of G' (both round an f32 sum once)."""
    g = _gen(20)
    image = torch.randn(2, 9, 11, c, generator=g).to(dtype).to(cuda)
    raw = _uv(2, 400, g).to(cuda)
    cot = torch.randn(2, 400, c, generator=g).to(cuda)
    _same_values(grid_sample_2d(image, raw, mode),
                 grid_sample_2d_reference(image, raw, mode))
    # the gradient at finite points in border mode: there autograd of the
    # plain version adds NaN for a NaN point and the edge pixel's share
    # for an infinite one, where G' (and its plain version) add nothing
    uv = raw.nan_to_num(0.0, 0.0, 0.0) if mode == "border" else raw
    counted = ("grid_sample_fwd", "grid_sample_bwd", "table_sample_fwd",
               "table_sample_bwd")
    before = [kernels.launches[k] for k in counted]
    leaf = image.clone().requires_grad_()
    out = grid_sample_2d(leaf, uv, mode)
    (grad,) = torch.autograd.grad(out, leaf, cot)
    assert [kernels.launches[k] - n for k, n in zip(counted, before)] == [
        1, 1, 0, 0]
    ref_leaf = image.float().clone().requires_grad_()
    ref = grid_sample_2d_reference(ref_leaf, uv, mode)
    (ref_grad,) = torch.autograd.grad(ref, ref_leaf, cot)
    assert out.dtype == torch.float32 and grad.dtype == dtype
    _same_values(out, ref.detach())
    if dtype == torch.float32:
        res = kernels.compare(grad, ref_grad, **GRID_SAMPLE_TOL)
    else:
        res = kernels.compare(grad.float(), ref_grad,
                              **GRID_SAMPLE_BF16_GRAD_TOL)
        assert res["ok"], res
        res = kernels.compare(grad, grid_sample_2d_backward_reference(
            cot, uv, image.shape, dtype, mode))
    assert res["ok"], res


@pytest.mark.cuda
def test_grid_sample_2d_kernel_non_finite_edge_pixel(cuda):
    """The one place G's values differ from its plain version's (ROADMAP,
    divergences): in zeros mode a corner outside the image adds +0 on the
    card, where the plain version multiplies the clamped edge pixel by 0.
    With inf in the image's last column, a point far to the right samples
    0 from G and NaN from the plain version; points whose four corners
    lie in the finite part of the image agree."""
    image = torch.randn(1, 6, 8, 4, generator=_gen(22))
    image[:, :, -1] = float("inf")
    uv = torch.tensor([[[5.0, 0.0], [0.0, 0.0], [-0.5, 0.4]]])
    image, uv = image.to(cuda), uv.to(cuda)
    out = grid_sample_2d(image, uv, "zeros")
    ref = grid_sample_2d_reference(image, uv, "zeros")
    assert torch.isnan(ref[0, 0]).all() and (out[0, 0] == 0).all()
    _same_values(out[0, 1:], ref[0, 1:])


@pytest.mark.cuda
@pytest.mark.parametrize("run", [1, 2, 5, 8, 32])
@pytest.mark.parametrize("c", [3, 32])
def test_grid_sample_2d_backward_kernel_runs(cuda, run, c):
    """Kernel G' at several run lengths on rows of points like a
    homography's (steps of 0.2 to 1.6 pixels along x, so consecutive
    points share a cell, step into the next one or jump), zeros and
    border mode, against its plain version (GRID_SAMPLE_TOL)."""
    g = _gen(21)
    b, h, w, n = 2, 12, 40, 1200
    x = torch.cumsum(torch.rand(b, n, generator=g) * 1.4 + 0.2, -1)
    x = torch.remainder(x, w + 6) - 3.0               # rows wrap, off edges
    y = torch.floor(torch.arange(n) * 3.0 / n * h / 3)[None].expand(b, n)
    y = y + torch.rand(b, n, generator=g) * 0.3 - 1.0
    uv = torch.stack([x / (w - 1) * 2 - 1, y / (h - 1) * 2 - 1], -1)
    uv[0, 7] = float("nan")
    uv = uv.to(cuda)
    cot = torch.randn(b, n, c, generator=g).to(cuda)
    for mode in ("zeros", "border"):
        out = grid_sample_2d_backward(cot, uv, (b, h, w, c), torch.float32,
                                      mode, run=run)
        ref = grid_sample_2d_backward_reference(cot, uv, (b, h, w, c),
                                                torch.float32, mode)
        res = kernels.compare(out, ref, **GRID_SAMPLE_TOL)
        assert res["ok"], (mode, res)


@pytest.mark.cuda
def test_grid_sample_2d_kernel_raises_rather_than_falling_back(cuda):
    uv = torch.zeros(1, 4, 2, device=cuda)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            grid_sample_2d(torch.zeros(1, 4, 4, 3, dtype=dtype, device=cuda),
                           uv)
    with pytest.raises(ValueError, match="one CUDA device"):
        grid_sample_2d(torch.zeros(1, 4, 4, 3), uv)
    with pytest.raises(ValueError, match="uv takes no gradient"):
        grid_sample_2d(torch.zeros(1, 4, 4, 3, device=cuda),
                       uv.clone().requires_grad_())
    with pytest.raises(ValueError, match="padding_mode"):
        grid_sample_2d(torch.zeros(1, 4, 4, 3, device=cuda), uv,
                       "reflection")
    with pytest.raises(ValueError, match="uv must be float32"):
        grid_sample_2d(torch.zeros(1, 4, 4, 3, device=cuda), uv.double())


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
    before = kernels.launches["composite_nerfpp_fwd"]
    out = composite_nerfpp(*args, white_bkgd)
    assert kernels.launches["composite_nerfpp_fwd"] == before + 1
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
    before = kernels.launches["pillar_collapse_fwd"]
    out = pillar_collapse(latent, *logits)
    assert kernels.launches["pillar_collapse_fwd"] == before + 1
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
        before = kernels.launches["table_sample_bwd"]
        out = table_sample_backward(cot, uv, shape, table_dtype, (h, w),
                                    mode, offset)
        assert kernels.launches["table_sample_bwd"] == before + 1
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
    before = kernels.launches["composite_nerfpp_bwd"]
    out = composite_nerfpp_backward(args, grads, white_bkgd)
    assert kernels.launches["composite_nerfpp_bwd"] == before + 1
    for o, r in zip(out, ref):
        res = kernels.compare(o, r, **RENDER_BWD_TOL)
        assert res["ok"], res


# C' cases: the first two are the original ones; then tiles that are
# ragged against the kernel's 8-value runs of y (Y = 5, 11, 10), Z = 3 and
# 5, C = 8 and 40 (16-byte vectors), C = 12 (bf16: 8-byte vectors), and the
# neo360_fast and neo360 paths' full widths (float32: g_xz too large to
# stage in shared memory)
PILLAR_BWD_SHAPES = [(2, 8, 6, 4, 40), (3, 16, 16, 8, 512), (2, 3, 5, 3, 8),
                     (1, 7, 11, 5, 40), (2, 4, 10, 5, 12),
                     (3, 64, 64, 32, 512), (3, 64, 64, 64, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PILLAR_BWD_SHAPES)
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
    before = kernels.launches["pillar_collapse_bwd"]
    out = pillar_collapse_backward(args, cots)
    assert kernels.launches["pillar_collapse_bwd"] == before + 1
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
    counted = ("table_sample_fwd", "table_sample_bwd")
    before = [kernels.launches[k] for k in counted]
    (ours,) = torch.autograd.grad(table_sample(table, uv, (15, 20)), table,
                                  cot)
    assert [kernels.launches[k] - n for k, n in zip(counted, before)] == [
        1, 1]
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
    before = kernels.launches["table_sample_bwd_acc"]
    for _ in range(3):
        uv = (_uv(3, 50, g, 1.4) if nonfinite
              else (torch.rand(3, 50, 2, generator=g) * 2 - 1) * 1.4)
        cot = torch.randn(3, 50, c, generator=g).to(grad_dtype)
        table_sample_accumulate(cot, uv, acc, (h, w), mode, view_offset)
        dense += table_sample_backward_reference(cot, uv, shape,
                                                 torch.float32, (h, w), mode,
                                                 view_offset)
    # no kernel on CPU
    assert kernels.launches["table_sample_bwd_acc"] == before
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
    before = kernels.launches["table_sample_bwd_acc"]
    for off in offsets:
        uv = _ray_uv(b, rays, s, g).to(cuda)
        cot = torch.randn(b, rays * s, shape[-1] // 4, generator=g).to(
            grad_dtype).to(cuda)
        table_sample_accumulate(cot, uv, acc, hw, mode, off)
        table_sample_accumulate_reference(cot, uv, ref, hw, mode, off)
    assert kernels.launches["table_sample_bwd_acc"] == before + len(offsets)
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
def test_table_sample_kernels_at_the_neo360_lift(cuda):
    """Kernels A and A' (dense) at the neo360 preset's float32 grid lift:
    the 512-channel pixel-latent table at every cell of a 64^3 grid of 3
    views."""
    g = _gen(22)
    table = torch.randn(3, 121, 161, 2048, generator=g).to(cuda)
    uv = _uv(3, 64 ** 3, g, lim=1.5).to(cuda)
    out = table_sample(table, uv, (120, 160), "zeros")
    _assert_ok(out, table_sample_reference(table, uv, (120, 160), "zeros"))
    cot = torch.randn(3, 64 ** 3, 512, generator=g).to(cuda)
    ref = table_sample_backward_reference(cot, uv, table.shape,
                                          torch.float32, (120, 160), "zeros")
    out = table_sample_backward(cot, uv, table.shape, torch.float32,
                                (120, 160), "zeros")
    res = kernels.compare(out, ref, **INTERP_BWD_TOL)
    assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("b,s_fg,s_bg", [
    (7, 1, 1), (33, 32, 33), (33, 33, 32), (5, 64, 1), (1, 97, 31),
    (256, 65, 65), (256, 61, 61), (256, 385, 385), (500, 129, 129)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,s_fg,s_bg", [
    (7, 1, 1), (33, 32, 33), (33, 33, 32), (5, 64, 1), (1, 97, 31),
    (250, 65, 65), (250, 61, 61), (500, 129, 129), (500, 385, 385)])
def test_composite_backward_kernel_chunk_edges(cuda, b, s_fg, s_bg):
    """Kernel B' (one warp per ray, forward product scans, reverse affine
    suffix scans over 32-sample chunks) at sample counts on and around the
    chunk edges and at the path's 250 rays, white_bkgd on and off, with
    every cotangent and with the loss's (rgb and both weights)."""
    g = _gen(16)
    args = tuple(a.to(cuda) for a in _composite_args(g, b, s_fg, s_bg))
    shapes = {k: v.shape for k, v in
              composite_nerfpp_reference(*args, False).items()}
    for white_bkgd in (False, True):
        for subset in (False, True):
            grads = [torch.randn(shapes[k], generator=g).to(cuda)
                     if not subset or k in ("rgb", "fg_weights",
                                            "bg_weights")
                     else None for k in OUT_KEYS]
            ref = _plain_composite_grads(args, grads, white_bkgd)
            out = composite_nerfpp_backward(args, grads, white_bkgd)
            for o, r in zip(out, ref):
                res = kernels.compare(o, r, **RENDER_BWD_TOL)
                assert res["ok"], (white_bkgd, subset, res)


def _composite_nonfinite(args):
    """Rays 0-3 with a NaN, +inf, zero and huge density at fg sample 2,
    rays 4-7 the same at bg sample 2, rays 8-11 at both."""
    args = [a.clone() for a in args]
    fg_sigma, bg_sigma = args[1], args[4]
    for r, v in enumerate((float("nan"), float("inf"), 0.0, 1e30)):
        fg_sigma[r, 2, 0] = fg_sigma[r + 8, 2, 0] = v
        bg_sigma[r + 4, 2, 0] = bg_sigma[r + 8, 2, 0] = v
    return tuple(args)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s_fg,s_bg", [
    (12, 3, 3), (33, 33, 32), (250, 61, 61), (256, 65, 65),
    (500, 129, 129), (12, 385, 385)])
def test_composite_nerfpp_kernels_nonfinite_densities(cuda, b, s_fg, s_bg):
    """Kernels B and B' with NaN, +inf, zero and huge densities in fg, in
    bg and in both, white background on and off, every cotangent and the
    loss's (rgb and both weights): NaN and inf where the plain version and
    its autograd have them, and within their tolerances (forward:
    compare()'s; backward: BACKWARD_TOL) elsewhere."""
    g = _gen(17)
    args = tuple(a.to(cuda) for a in _composite_nonfinite(
        _composite_args(g, b, s_fg, s_bg)))
    shapes = {k: v.shape for k, v in
              composite_nerfpp_reference(*args, False).items()}
    for white_bkgd in (False, True):
        ref = composite_nerfpp_reference(*args, white_bkgd)
        out = composite_nerfpp(*args, white_bkgd)
        for k in ref:
            _assert_ok_where_finite(out[k], ref[k])
        for subset in (False, True):
            grads = [torch.randn(shapes[k], generator=g).to(cuda)
                     if not subset or k in ("rgb", "fg_weights",
                                            "bg_weights")
                     else None for k in OUT_KEYS]
            ref_g = _plain_composite_grads(args, grads, white_bkgd)
            out_g = composite_nerfpp_backward(args, grads, white_bkgd)
            for o, r in zip(out_g, ref_g):
                _assert_ok_where_finite(o, r, **RENDER_BWD_TOL)


# --- the new kernels' arithmetic orders, emulated in float32 on the CPU --
#
# Each emulation repeats its kernel's operations in its order, one float32
# rounding per operation (the card may fuse a multiply and an add), and is
# held to autograd of the plain version within the kernel's own
# BACKWARD_TOL: the orders the card runs fit the tolerances it must meet.

_LANE = torch.arange(32)


def _xor_sum(v):
    """Sum over the last axis (32 lanes) in __shfl_xor_sync tree order."""
    for d in (16, 8, 4, 2, 1):
        v = v + v[..., _LANE ^ d]
    return v


def _lanes(x, n, fill):
    """(B, n) values into 32 lanes, lanes past n set to `fill`."""
    out = torch.full((x.shape[0], 32), fill, dtype=torch.float32)
    out[:, :n] = x
    return out


def _forward_scan(alpha):
    """Kernel B's chunked exclusive transmittance: a Hillis-Steele
    __shfl_up_sync product scan of q = (1 - alpha) + 1e-10 per 32-sample
    chunk, carried across chunks. Returns A (B,S) and the transmittance
    past the last sample (B,)."""
    b, s = alpha.shape
    trans = torch.ones(b)
    a_out = torch.empty(b, s)
    for base in range(0, s, 32):
        n = min(32, s - base)
        incl = _lanes((1.0 - alpha[:, base:base + n]) + 1e-10, n, 1.0)
        for d in (1, 2, 4, 8, 16):
            up = torch.cat([incl[:, :d], incl[:, :-d]], 1)
            incl = torch.where(_LANE >= d, incl * up, incl)
        excl = torch.cat([torch.ones(b, 1), incl[:, :-1]], 1)
        a_out[:, base:base + n] = (trans[:, None] * excl)[:, :n]
        trans = trans * incl[:, 31]
    return a_out, trans


def _reverse_scan(q, c, g_top):
    """Kernel B′'s reverse pass: G_{i-1} = q_i G_i + c_i from G_{S-1} =
    g_top, per 32-sample chunk from the last down, by an exclusive
    __shfl_down_sync suffix scan of the affine maps (q, c). Returns G_i
    (B,S)."""
    b, s = q.shape
    out = torch.empty(b, s)
    G = g_top
    for base in range((s - 1) // 32 * 32, -1, -32):
        n = min(32, s - base)
        Q = _lanes(q[:, base:base + n], n, 1.0)
        C = _lanes(c[:, base:base + n], n, 0.0)
        for d in (1, 2, 4, 8, 16):
            qd = torch.cat([Q[:, d:], Q[:, -d:]], 1)
            cd = torch.cat([C[:, d:], C[:, -d:]], 1)
            live = _LANE + d < 32
            C, Q = torch.where(live, Q * cd + C, C), torch.where(live, Q * qd,
                                                                 Q)
        qx = torch.cat([Q[:, 1:], torch.ones(b, 1)], 1)
        cx = torch.cat([C[:, 1:], torch.zeros(b, 1)], 1)
        out[:, base:base + n] = (qx * G[:, None] + cx)[:, :n]
        G = Q[:, 0] * G + C[:, 0]
    return out


def _emulate_composite_backward(args, grads, white_bkgd):
    """Kernel B′ in float32, in its order of operations."""
    fg_rgb, fg_sigma, fg_t, bg_rgb, bg_sigma, bg_t, dirs, far = args
    g = {k: v for k, v in zip(OUT_KEYS, grads)}
    b = dirs.shape[0]
    zero = torch.zeros(b)

    def get(key, shape):
        return g[key].reshape(shape) if g.get(key) is not None else \
            torch.zeros(shape)

    dnorm = torch.sqrt(dirs[:, 0] * dirs[:, 0] + dirs[:, 1] * dirs[:, 1]
                       + dirs[:, 2] * dirs[:, 2])

    def branch(rgb, sigma, t, fg):
        if fg:
            nxt = torch.cat([t[:, 1:], far], 1)
            delta = (nxt - t) * dnorm[:, None]
        else:
            delta = torch.cat([t[:, :-1] - t[:, 1:],
                               torch.full((b, 1), 1e10)], 1)
        e = torch.exp(-sigma[..., 0] * delta)
        alpha = 1.0 - e
        a, trans = _forward_scan(alpha)
        w = alpha * a
        return dict(rgb=rgb, t=t, delta=delta, e=e, alpha=alpha, a=a, w=w,
                    trans=trans)

    def lane_sum(x):   # lane partials across chunks, then the xor tree
        s = x.shape[1]
        part = torch.zeros(b, 32)
        for base in range(0, s, 32):
            n = min(32, s - base)
            part = part + _lanes(x[:, base:base + n], n, 0.0)
        return _xor_sum(part)[:, 0]

    f, bg = branch(fg_rgb, fg_sigma, fg_t, True), branch(bg_rgb, bg_sigma,
                                                         bg_t, False)
    bsum = [lane_sum(bg["w"] * bg["rgb"][..., k]) for k in range(3)]
    bacc, bdepth = lane_sum(bg["w"]), lane_sum(bg["w"] * bg["t"])
    if white_bkgd:
        bsum = [x + (1.0 - bacc) for x in bsum]
    lam = f["trans"]
    gc = get("rgb", (b, 3))
    gf = gc + get("fg_rgb", (b, 3))
    gb = lam[:, None] * gc + get("bg_rgb", (b, 3))
    gdepth = get("depth", (b,))
    g_top = get("bg_lambda", (b,)) + gc[:, 0] * bsum[0] + gc[:, 1] * bsum[1]
    g_top = g_top + gc[:, 2] * bsum[2] + gdepth * bdepth

    def backward(br, gcb, gd, ga, gw, top):
        if white_bkgd:
            ga = ga - (gcb[:, 0] + gcb[:, 1] + gcb[:, 2])
        gwi = gw + ga[:, None]
        for k in range(3):
            gwi = gwi + gcb[:, k:k + 1] * br["rgb"][..., k]
        gwi = gwi + gd[:, None] * br["t"]
        q = (1.0 - br["alpha"]) + 1e-10
        G = _reverse_scan(q, gwi * br["alpha"], top)
        dsigma = br["a"] * (gwi - G) * br["e"] * br["delta"]
        return br["w"][..., None] * gcb[:, None, :], dsigma[..., None]

    s_fg, s_bg = fg_t.shape[1], bg_t.shape[1]
    d_fg = backward(f, gf, gdepth + get("fg_depth", (b,)),
                    get("fg_acc", (b,)), get("fg_weights", (b, s_fg)), g_top)
    d_bg = backward(bg, gb, lam * gdepth, get("bg_acc", (b,)),
                    get("bg_weights", (b, s_bg)), zero)
    return d_fg + d_bg


@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("s", [1, 5, 31, 32, 33, 64, 65, 97])
def test_composite_backward_scan_order_fits_tolerance(s, white_bkgd):
    """CPU: kernel B′'s chunked forward product scan and reverse affine
    suffix scan, in tree order, against autograd of the plain version
    within BACKWARD_TOL, with every cotangent and with the loss's; the bg
    branch is 6 samples shorter (at least 1)."""
    g = _gen(17)
    args = _composite_args(g, 40, s, max(s - 6, 1))
    shapes = {k: v.shape for k, v in
              composite_nerfpp_reference(*args, white_bkgd).items()}
    for subset in (False, True):
        grads = [torch.randn(shapes[k], generator=g)
                 if not subset or k in ("rgb", "fg_weights", "bg_weights")
                 else None for k in OUT_KEYS]
        ref = _plain_composite_grads(args, grads, white_bkgd)
        out = _emulate_composite_backward(args, grads, white_bkgd)
        for o, r in zip(out, ref):
            res = kernels.compare(o, r, **RENDER_BWD_TOL)
            assert res["ok"], (subset, res)


def _emulate_pillar_backward(args, grads):
    """Kernel C′ in float32, in its order of operations: the prologue's
    f32 softmax (sums in axis order), the main pass's rounded weights, d
    latent and per-cell dot products (each lane sums its VEC-wide vectors
    v = lane, lane + 32, ... in order, then the xor tree), the epilogue's
    axis-order sum and logit gradient."""
    latent, *logits = args
    dt = latent.dtype
    nv, x, y, z, c = latent.shape
    vec = 8 if dt == torch.bfloat16 and c % 8 == 0 else 4
    lat = latent.float()

    def softmax(logit, axis):
        lg = logit.float().movedim(axis, -1)
        m = lg.amax(-1, keepdim=True)
        total = torch.zeros(lg.shape[:-1])
        for i in range(lg.shape[-1]):
            total = total + torch.exp(lg[..., i] - m[..., 0])
        return (torch.exp(lg - m) / total[..., None]).movedim(-1, axis)

    w32 = [softmax(logits[0], 1), softmax(logits[1], 2),
           softmax(logits[2], 3)]
    wb = [w.to(dt).float() for w in w32]
    gf = [grads[0].float()[:, None], grads[1].float()[:, :, None],
          grads[2].float()[:, :, :, None]]     # broadcast over the cells
    gf = [gg.expand(nv, x, y, z, c) for gg in gf]
    d_latent = wb[0][..., None] * gf[0]
    d_latent = d_latent + wb[1][..., None] * gf[1]
    d_latent = d_latent + wb[2][..., None] * gf[2]

    def dot(gg):
        prod = (gg * lat).reshape(-1, c // vec, vec)
        part = torch.zeros(prod.shape[0], 32)
        for v in range(c // vec):
            for k in range(vec):
                part[:, v % 32] = part[:, v % 32] + prod[:, v, k]
        return _xor_sum(part)[:, 0].reshape(nv, x, y, z).to(dt).float()

    d_logits = []
    for f, axis in enumerate((1, 2, 3)):
        w = w32[f].movedim(axis, -1)
        dw = dot(gf[f]).movedim(axis, -1)
        s = torch.zeros(w.shape[:-1])
        for i in range(w.shape[-1]):
            s = s + w[..., i] * dw[..., i]
        d_logits.append((w * (dw - s[..., None])).movedim(-1, axis).to(dt))
    return (d_latent.to(dt), *d_logits)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5, 4, 3, 8), (1, 3, 11, 5, 40),
                                   (2, 4, 10, 2, 12)])
def test_pillar_backward_order_fits_tolerance(dtype, shape):
    """CPU: kernel C′'s arithmetic order against autograd of the plain
    version within its BACKWARD_TOL (d latent: the forward's tolerance;
    d logit: per dtype), C = 12 taking bf16's 8-byte vectors."""
    g = _gen(18)
    nv, x, y, z, c = shape
    args = [torch.randn(shape, generator=g).to(dtype)] + [
        (torch.randn(nv, x, y, z, generator=g) * 3).to(dtype)
        for _ in range(3)]
    cots = [torch.randn(s, generator=g).to(dtype) for s in
            ((nv, y, z, c), (nv, x, z, c), (nv, x, y, c))]
    leaves = [a.detach().requires_grad_() for a in args]
    ref = torch.autograd.grad(pillar_collapse_reference(*leaves), leaves,
                              cots)
    out = _emulate_pillar_backward(args, cots)
    res = kernels.compare(out[0], ref[0], **PILLAR_BWD_TOL["latent"])
    assert res["ok"], res
    for o, r in zip(out[1:], ref[1:]):
        res = kernels.compare(o, r, **PILLAR_BWD_TOL["logit"][dtype])
        assert res["ok"], res


# kernel C's lanes per z (csrc/pillar_collapse.cu: kLanesPerZ); its warps
# (8 x lanes per z), y slots (64 / warps) and z lanes (32 / lanes per z)
# follow from it; its z chunks are 2 up to Z = 32 and 4 up to Z = 64
C_LANES_PER_Z = 2


def _emulate_pillar_forward(args):
    """Kernel C in float32, in its order of operations: the prologue's f32
    softmax (sums in axis order) rounded to the latent's type; warp w, lane
    (zl, h) of a block take y = w + sy * warps and z = zl + cz * z_lanes,
    with dead y and z contributing zero; floor_yz sums over x in order,
    floor_xy over the z chunks and then the xor tree over the z lanes,
    floor_xz over the y slots and then over the warps in order; one
    rounding. Channels never mix, so the channel slices need no
    emulation."""
    latent, *logits = args
    dt = latent.dtype
    nv, x, y, z, c = latent.shape
    warps, z_lanes = 8 * C_LANES_PER_Z, 32 // C_LANES_PER_Z
    y_slots, z_chunks = 64 // warps, 2 if z <= 32 else 4
    zmax = z_chunks * z_lanes

    def softmax(logit, axis):
        lg = logit.float().movedim(axis, -1)
        m = lg.amax(-1, keepdim=True)
        total = torch.zeros(lg.shape[:-1])
        for i in range(lg.shape[-1]):
            total = total + torch.exp(lg[..., i] - m[..., 0])
        return (torch.exp(lg - m) / total[..., None]).movedim(-1, axis)

    pad = (0, 0, 0, zmax - z, 0, 64 - y)   # (C, Z, Y) to 64 x zmax
    lat = torch.nn.functional.pad(latent.float(), pad)
    prods = [torch.nn.functional.pad(
        softmax(lg, axis).to(dt).float()[..., None], pad) * lat
        for lg, axis in zip(logits, (1, 2, 3))]

    yz = torch.zeros(nv, 64, zmax, c)
    for i in range(x):
        yz = yz + prods[0][:, i]

    p = prods[2].reshape(nv, x, 64, z_chunks, z_lanes, c)
    xy = torch.zeros(nv, x, 64, z_lanes, c)
    for cz in range(z_chunks):
        xy = xy + p[:, :, :, cz]
    lane = torch.arange(z_lanes)
    d = z_lanes // 2
    while d:
        xy = xy + xy[:, :, :, lane ^ d]
        d //= 2
    xy = xy[:, :, :, 0]

    p = prods[1].reshape(nv, x, y_slots, warps, zmax, c)
    part = torch.zeros(nv, x, warps, zmax, c)
    for sy in range(y_slots):
        part = part + p[:, :, sy]
    xz = torch.zeros(nv, x, zmax, c)
    for w in range(warps):
        xz = xz + part[:, :, w]
    return (yz[:, :y, :z].to(dt), xz[:, :, :z].to(dt), xy[:, :, :y].to(dt))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5, 4, 3, 8), (1, 3, 11, 5, 40),
                                   (2, 4, 10, 2, 12), (1, 7, 19, 9, 12),
                                   (1, 2, 64, 32, 4)])
def test_pillar_forward_order_fits_tolerance(dtype, shape):
    """CPU: kernel C's arithmetic order against its plain version within
    `kernels.compare`'s tolerance, at grids ragged against the warps, z
    lanes and channel slices (C = 12 and 40: a slice's second vector
    missing), and at the largest Y and Z the kernel takes."""
    g = _gen(19)
    nv, x, y, z, c = shape
    args = [torch.randn(shape, generator=g).to(dtype)] + [
        (torch.randn(nv, x, y, z, generator=g) * 3).to(dtype)
        for _ in range(3)]
    for o, r in zip(_emulate_pillar_forward(args),
                    pillar_collapse_reference(*args)):
        _assert_ok(o, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 3, 5, 33, 8), (2, 4, 19, 48, 12),
                                   (1, 2, 64, 64, 4)])
def test_pillar_forward_order_fits_tolerance_above_32_z(dtype, shape):
    """CPU: kernel C's order with four z chunks (33 <= Z <= 64, the neo360
    preset's 64^3 grid) against its plain version within
    `kernels.compare`'s tolerance: one z of the last chunk, a ragged
    chunk, and the largest Y and Z the kernel takes."""
    g = _gen(21)
    nv, x, y, z, c = shape
    args = [torch.randn(shape, generator=g).to(dtype)] + [
        (torch.randn(nv, x, y, z, generator=g) * 3).to(dtype)
        for _ in range(3)]
    for o, r in zip(_emulate_pillar_forward(args),
                    pillar_collapse_reference(*args)):
        _assert_ok(o, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 64, 64, 32, 512), (2, 7, 11, 5, 12),
                                   (1, 5, 64, 32, 40), (2, 3, 1, 1, 4),
                                   (3, 64, 64, 64, 512), (2, 5, 19, 48, 12),
                                   (1, 3, 64, 33, 40)])
def test_pillar_collapse_kernel_path_and_ragged(cuda, dtype, shape):
    """Kernel C at the neo360_fast (Z = 32) and neo360 (Z = 64) grid
    latents and at grids ragged in X, Y, Z and the channel slices, on both
    sides of Z = 32, twice: the same bits both times."""
    g = _gen(20)
    nv, x, y, z, c = shape
    latent = torch.randn(shape, generator=g).to(dtype).to(cuda)
    logits = [(torch.randn(nv, x, y, z, generator=g) * 3).to(dtype).to(cuda)
              for _ in range(3)]
    ref = pillar_collapse_reference(latent, *logits)
    before = kernels.launches["pillar_collapse_fwd"]
    out = pillar_collapse(latent, *logits)
    again = pillar_collapse(latent, *logits)
    assert kernels.launches["pillar_collapse_fwd"] == before + 2
    for o, a, r in zip(out, again, ref):
        _assert_ok(o, r)
        assert torch.equal(o, a)


@pytest.mark.cuda
def test_pillar_collapse_kernel_rejects_shapes_it_does_not_take(cuda):
    for shape in ((1, 4, 65, 4, 8), (1, 4, 4, 65, 8), (1, 4, 4, 4, 6)):
        latent = torch.zeros(shape, device=cuda)
        logit = torch.zeros(shape[:4], device=cuda)
        with pytest.raises(ValueError, match="pillar_collapse"):
            pillar_collapse(latent, logit, logit, logit)


# --- kernel A's fold and the fused tri-plane / local gathers -------------
# (csrc/table_sample_common.cuh, table_sample.cu, triplane_sample.cu,
# local_sample.cu)

def _emulate_corners(u, v, hw, zeros, view):
    """Each point's row (-1: outside) and four f32 weights, in the order of
    `neo360::corner`: border mode clamps keeping NaN; zeros mode leaves
    points outside the one-pixel pad (and non-finite ones) out."""
    h, w = hw
    ix = (u + 1.0) * 0.5 * (w - 1)
    iy = (v + 1.0) * 0.5 * (h - 1)
    if not zeros:
        ix = torch.where(ix.isnan(), ix, ix.clamp(0.0, w - 1.0))
        iy = torch.where(iy.isnan(), iy, iy.clamp(0.0, h - 1.0))
    x0, y0 = torch.floor(ix), torch.floor(iy)
    fx, fy = ix - x0, iy - y0
    wts = torch.stack([(1.0 - fx) * (1.0 - fy), fx * (1.0 - fy),
                       (1.0 - fx) * fy, fx * fy], -1)
    xb = torch.nan_to_num(torch.clamp(x0 + 1.0, 0.0, w)).long()
    yb = torch.nan_to_num(torch.clamp(y0 + 1.0, 0.0, h)).long()
    row = (view * (h + 1) + yb) * (w + 1) + xb
    if zeros:
        inside = (x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)
        row = torch.where(inside, row, torch.full_like(row, -1))
    return row, wts


def _emulate_walk(corners, tables, c, vec, run):
    """The kernels' walk in float32: blocks of 256 threads hold groups of
    C/vec lanes, each walking `run` consecutive points (cut so that a
    block's corners fit 48 KB) with one row cache per table, reloading a
    row only when the point's row changes; the tables' folds are summed in
    table order ((xz + xy) + yz). corners: per table (rows (P,), weights
    (P, 4)); tables: per table its flat (rows, 4C) f32 view."""
    k = len(tables)
    points = corners[0][0].numel()
    groups = 256 // (c // vec)
    run = max(1, min(run, 48 * 1024 // (groups * k * 32)))
    out = torch.zeros(points, c)
    for first in range(0, points, run):      # a group's run
        cache = [(-1, None)] * k
        for p in range(first, min(first + run, points)):
            total = None
            for j, ((rows, wts), table) in enumerate(zip(corners, tables)):
                row = int(rows[p])
                if row < 0:
                    val = torch.zeros(c)
                else:
                    if row != cache[j][0]:
                        cache[j] = (row, table[row])
                    r = cache[j][1].reshape(4, c)
                    wp = wts[p]
                    val = (r[0] * wp[0] + r[1] * wp[1] + r[2] * wp[2]
                           + r[3] * wp[3])
                total = val if total is None else total + val
            out[p] = total
    return out


def _table_views(b, n, view_offset, total):
    return torch.clamp(torch.arange(b) + view_offset, 0,
                       total - 1)[:, None].expand(b, n).reshape(-1)


def _emulate_triplane(tables, cam, hw, view_offset, run):
    b, n = cam.shape[:2]
    c = tables[0].shape[-1] // 4
    view = _table_views(b, n, view_offset, tables[0].shape[0])
    x, y, z = (cam[..., i].reshape(-1) for i in range(3))
    corners = [_emulate_corners(u, v, hw, True, view)
               for u, v in ((x, z), (x, y), (y, z))]
    flat = [t.float().reshape(-1, 4 * c) for t in tables]
    vec = 16 // tables[0].element_size()
    return _emulate_walk(corners, flat, c, vec, run).reshape(b, n, c)


def _emulate_local(table, cam, focal, cc, scale, hw, view_offset, run):
    """Row r of the output takes branch r // NV, view r % NV, point
    q = (view * 2 + branch) * M + m of cam; uv as the kernel's rounded
    operations."""
    nv, m = cam.shape[0], cam.shape[1] // 2
    c = table.shape[-1] // 4
    r = torch.arange(2 * nv)[:, None].expand(2 * nv, m)
    branch, view = r // nv, r % nv
    q = ((view * 2 + branch) * m + torch.arange(m)[None]).reshape(-1)
    pts = cam.reshape(-1, 3)[q]
    zd = pts[:, 2] + torch.tensor(1e-9, dtype=torch.float32)
    f = focal[0]
    u = (-pts[:, 0] / zd * f + cc[0, 0]) * scale[0] - 1.0
    v = (-pts[:, 1] / zd * -f + cc[0, 1]) * scale[1] - 1.0
    tview = torch.clamp(r.reshape(-1) + view_offset, 0, table.shape[0] - 1)
    corners = [_emulate_corners(u, v, hw, False, tview)]
    flat = [table.float().reshape(-1, 4 * c)]
    vec = 16 // table.element_size()
    return _emulate_walk(corners, flat, c, vec, run).reshape(2 * nv, m, c)


def _ray_cam(nv, n_rays, s, g, lim=1.2):
    """Camera points (nv, 2 * n_rays * s, 3) of [fg | bg] halves: `s`
    consecutive samples along each of `n_rays` short segments (consecutive
    points often share a cell), some behind the camera (z > 0), the first
    few non-finite, huge or on the camera plane."""
    start = (torch.rand(nv, 2 * n_rays, 1, 3, generator=g) * 2 - 1) * lim
    step = torch.randn(nv, 2 * n_rays, 1, 3, generator=g) * 0.2
    t = torch.sort(torch.rand(nv, 2 * n_rays, s, 1, generator=g), 2).values
    cam = (start + t * step).reshape(nv, 2 * n_rays * s, 3)
    cam[..., 2] -= 1.0
    cam[0, :4] = torch.tensor([[float("inf"), 0.2, -1.0],
                               [0.1, -float("inf"), -0.5],
                               [0.1, 0.2, 0.0], [1e30, 0.1, -1.0]])
    return cam


FOCAL, CENTRE, SCALE = (torch.tensor([9.0, 8.5, 9.5]),
                        torch.tensor([[10.0, 7.5], [9.0, 7.0], [11.0, 8.0]]),
                        (0.11, 0.13))


@pytest.mark.parametrize("run", [1, 4, 7, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_gather_order_fits_tolerance(dtype, run):
    """CPU: the walk of the fused kernels (a run of points per group of
    lanes, a row cache per table, the tri-plane sum in table order, the
    local kernel's row -> (branch, view) map and projection) against their
    plain versions within FUSED_TOL, at flat two-scene tables (scene 1:
    view offsets 3 and 6), views whose point counts the run does not
    divide, and non-finite points (NaN in the tri-plane's zeros mode)."""
    g = _gen(40)
    hw, c = (11, 13), 16
    planes = [build_corner_table(torch.randn(6, *hw, c, generator=g),
                                 "zeros", dtype=dtype) for _ in range(3)]
    local = build_corner_table(torch.randn(12, *hw, c, generator=g),
                               "border", dtype=dtype)
    cam = _ray_cam(3, 5, 7, g)
    tri_cam = cam.clone()
    tri_cam[1, 3] = float("nan")
    res = kernels.compare(_emulate_triplane(planes, tri_cam, hw, 3, run),
                          triplane_sample_reference(planes, tri_cam, hw, 3),
                          **FUSED_TOL)
    assert res["ok"], res
    res = kernels.compare(
        _emulate_local(local, cam, FOCAL, CENTRE, SCALE, hw, 6, run),
        local_sample_reference(local, cam, FOCAL, CENTRE, SCALE, hw, 6),
        **FUSED_TOL)
    assert res["ok"], res


@pytest.mark.parametrize("run", [1, 16])
def test_table_sample_walk_fits_tolerance(run):
    """CPU: kernel A's walk (one table) against its plain version at a
    grid lift's uv, consecutive z cells of a pillar sharing rows, views
    crossing inside a run."""
    g = _gen(41)
    hw, c = (15, 20), 8
    table = build_corner_table(torch.randn(3, *hw, c, generator=g), "zeros")
    pillar = torch.rand(3, 10, 1, 2, generator=g) * 2 - 1
    uv = (pillar + torch.linspace(0, 0.3, 9)[None, None, :, None]).reshape(
        3, 90, 2)
    view = _table_views(3, 90, 0, 3)
    corners = [_emulate_corners(uv[..., 0].reshape(-1),
                                uv[..., 1].reshape(-1), hw, True, view)]
    out = _emulate_walk(corners, [table.reshape(-1, 4 * c)], c, 4, run)
    _assert_ok(out.reshape(3, 90, c),
               table_sample_reference(table, uv, hw, "zeros"))


def _fused_case(cuda, dtype, hw, c, nv, n_rays, s, scenes, g):
    planes = [build_corner_table(torch.randn(nv * scenes, *hw, c,
                                             generator=g), "zeros",
                                 dtype=dtype).to(cuda) for _ in range(3)]
    local = build_corner_table(torch.randn(2 * nv * scenes, *hw, c,
                                           generator=g), "border",
                               dtype=dtype).to(cuda)
    cam = _ray_cam(nv, n_rays, s, g).to(cuda)
    return planes, local, cam


def _assert_unfused_bits(tri, loc, planes, local, tri_cam, cam, focal,
                         centre, scale, hw, off, run=None):
    """The fused kernels' outputs `tri` and `loc` are the bits of the
    unfused chain they replace: three kernel A calls (at run length `run`)
    summed as (xz + xy) + yz, and `local_uv` then kernel A in border mode
    (NaN where a non-finite point keeps it)."""
    xz, xy, yz = (table_sample(t, uv, hw, "zeros", torch.float32, off,
                               run=run)
                  for t, uv in zip(planes, triplane_uvs(tri_cam)))
    torch.testing.assert_close(tri, xz + xy + yz, rtol=0, atol=0)
    unfused = table_sample(local, local_uv(cam, focal, centre, scale), hw,
                           "border", torch.float32, 2 * off, run=run)
    torch.testing.assert_close(loc, unfused, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("run", [1, 3, 4, 16, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_gather_kernels(cuda, dtype, run):
    """The fused tri-plane and local kernels and kernel A against their
    plain versions on the card at small ragged shapes, at every run length
    (a run of 64 is cut to what 48 KB of corners allow), with flat
    two-scene tables and non-finite points; the fused kernels also against
    the unfused chain, bit for bit."""
    g = _gen(42)
    hw = (15, 20)
    planes, local, cam = _fused_case(cuda, dtype, hw, 32, 3, 7, 13, 2, g)
    tri_cam = cam.clone()
    tri_cam[1, 3] = float("nan")
    focal, centre = FOCAL.to(cuda), CENTRE.to(cuda)
    for off in (0, 3):
        before = kernels.launches["triplane_sample_fwd"]
        tri = triplane_sample(planes, tri_cam, hw, off, run=run)
        assert kernels.launches["triplane_sample_fwd"] == before + 1
        res = kernels.compare(tri, triplane_sample_reference(
            planes, tri_cam, hw, off), **FUSED_TOL)
        assert res["ok"], res
        before = kernels.launches["local_sample_fwd"]
        loc = local_sample(local, cam, focal, centre, SCALE, hw, 2 * off,
                           run=run)
        assert kernels.launches["local_sample_fwd"] == before + 1
        res = kernels.compare(loc, local_sample_reference(
            local, cam, focal, centre, SCALE, hw, 2 * off), **FUSED_TOL)
        assert res["ok"], res
        _assert_unfused_bits(tri, loc, planes, local, tri_cam, cam, focal,
                             centre, SCALE, hw, off, run)
        uv = local_uv(cam, focal, centre, SCALE)
        _assert_ok(table_sample(local, uv, hw, "border", view_offset=off,
                                run=run),
                   table_sample_reference(local, uv, hw, "border",
                                          view_offset=off))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_rays,s", [(256, 61), (256, 385), (500, 129)])
def test_fused_gather_kernels_at_path_shapes(cuda, dtype, n_rays, s):
    """The fused kernels at the render tiles and training steps of both
    presets: 120x160 tables of 128 channels, 3 views, [fg | bg] points;
    against their plain versions and, bit for bit, the unfused chain."""
    g = _gen(43)
    hw = (120, 160)
    planes, local, cam = _fused_case(cuda, dtype, hw, 128, 3, n_rays, s, 1,
                                     g)
    tri = triplane_sample(planes, cam, hw)
    res = kernels.compare(tri, triplane_sample_reference(planes, cam, hw),
                          **FUSED_TOL)
    assert res["ok"], res
    focal, centre = FOCAL.to(cuda) * 16, CENTRE.to(cuda) * 16
    scale = (0.0063, 0.0084)
    loc = local_sample(local, cam, focal, centre, scale, hw)
    res = kernels.compare(loc, local_sample_reference(local, cam, focal,
                                                      centre, scale, hw),
                          **FUSED_TOL)
    assert res["ok"], res
    _assert_unfused_bits(tri, loc, planes, local, cam, cam, focal, centre,
                         scale, hw, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("accumulate", [False, True])
def test_fused_gather_gradients_on_the_card(cuda, accumulate):
    """The fused Functions' table gradients on the card (kernel A' fed
    their rebuilt uv) against the unfused calls' (kernel A' fed the uv
    tensors), within kernel A''s BACKWARD_TOL (its atomics add in another
    order each run)."""
    g = _gen(44)
    hw = (15, 20)
    planes, local, cam = _fused_case(cuda, torch.float32, hw, 32, 3, 7, 13,
                                     2, g)
    focal, centre = FOCAL.to(cuda), CENTRE.to(cuda)
    cot_w = torch.randn(3, cam.shape[1], 32, generator=g).to(cuda)
    cot_l = torch.randn(6, cam.shape[1] // 2, 32, generator=g).to(cuda)
    grads = []
    for fused in (True, False):
        leaves = [t.clone().requires_grad_() for t in planes + [local]]
        accs = [torch.zeros(t.shape, device=cuda) for t in leaves] \
            if accumulate else [None] * 4
        if fused:
            world = triplane_sample(leaves[:3], cam, hw, 3, grad_acc=(
                tuple(accs[:3]) if accumulate else None))
            loc = local_sample(leaves[3], cam, focal, centre, SCALE, hw, 6,
                               grad_acc=accs[3])
        else:
            world = sum(table_sample(t, uv, hw, "zeros", view_offset=3,
                                     grad_acc=a) for t, uv, a in zip(
                leaves[:3], triplane_uvs(cam), accs[:3]))
            loc = table_sample(leaves[3], local_uv(cam, focal, centre,
                                                   SCALE), hw, "border",
                               view_offset=6, grad_acc=accs[3])
        got = torch.autograd.grad((world, loc), leaves, (cot_w, cot_l),
                                  allow_unused=True)
        grads.append(accs if accumulate else got)
    for ours, ref in zip(*grads):
        res = kernels.compare(ours, ref, **INTERP_BWD_TOL)
        assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [32, 64, 96])
def test_kernels_at_the_narrow_widths(cuda, dtype, c):
    """The NeRFTP width knobs on the card: the fused tri-plane and local
    gathers at `plane_dim` / `local_proj_dim` = C (120x160 tables, flat
    two-scene offsets, a neo360_fast step's 250 rays x 61 points), their
    table gradients under the accumulate contract (kernel A') against the
    index_add_ plain version, and kernel C on a (3, 16, 16, 32, C)
    latent: within FUSED_TOL, INTERP_BWD_TOL and compare()'s."""
    g = _gen(47)
    hw = (120, 160)
    planes, local, cam = _fused_case(cuda, dtype, hw, c, 3, 250, 61, 2, g)
    focal, centre = FOCAL.to(cuda) * 16, CENTRE.to(cuda) * 16
    scale = (0.0063, 0.0084)
    tri = triplane_sample(planes, cam, hw, 3)
    res = kernels.compare(tri, triplane_sample_reference(planes, cam, hw, 3),
                          **FUSED_TOL)
    assert res["ok"], res
    loc = local_sample(local, cam, focal, centre, scale, hw, 6)
    res = kernels.compare(loc, local_sample_reference(
        local, cam, focal, centre, scale, hw, 6), **FUSED_TOL)
    assert res["ok"], res
    leaves = [t.clone().requires_grad_() for t in planes + [local]]
    accs = [torch.zeros(t.shape, device=cuda) for t in leaves]
    world = triplane_sample(leaves[:3], cam, hw, 3, grad_acc=tuple(accs[:3]))
    loc = local_sample(leaves[3], cam, focal, centre, scale, hw, 6,
                       grad_acc=accs[3])
    cot_w = torch.randn(world.shape, generator=g).to(cuda)
    cot_l = torch.randn(loc.shape, generator=g).to(cuda)
    before = kernels.launches["table_sample_bwd_acc"]
    torch.autograd.grad((world, loc), leaves, (cot_w, cot_l),
                        allow_unused=True)
    assert kernels.launches["table_sample_bwd_acc"] == before + 4
    refs = [torch.zeros(t.shape, device=cuda) for t in leaves]
    for t_ref, uv in zip(refs[:3], triplane_uvs(cam)):
        table_sample_accumulate_reference(cot_w, uv, t_ref, hw, "zeros", 3)
    table_sample_accumulate_reference(
        cot_l, local_uv(cam, focal, centre, scale), refs[3], hw, "border", 6)
    for ours, ref in zip(accs, refs):
        res = kernels.compare(ours, ref, **INTERP_BWD_TOL)
        assert res["ok"], res
    latent = torch.randn(3, 16, 16, 32, c, generator=g).to(dtype).to(cuda)
    logits = [(torch.randn(3, 16, 16, 32, generator=g) * 3).to(dtype).to(
        cuda) for _ in range(3)]
    for o, r in zip(pillar_collapse(latent, *logits),
                    pillar_collapse_reference(latent, *logits)):
        _assert_ok(o, r)


# --- kernels D / D': the plain NeRF composite ----------------------------

def _vanilla_args(g, b, s, tiny_last=False):
    """rgb, density in [0, 10), ascending t in [0.2, 3], dirs
    (unnormalized). `tiny_last`: the last sample's density in [1e-12,
    1e-9], so its 1e10-wide interval leaves alpha below 1 and the
    transmittance past it matters."""
    t = 0.2 + 2.8 * torch.sort(torch.rand(b, s, generator=g), -1).values
    density = torch.rand(b, s, 1, generator=g) * 10
    if tiny_last:
        density[:, -1, 0] = 10.0 ** (-12 + 3 * torch.rand(b, generator=g))
    return (torch.rand(b, s, 3, generator=g), density, t,
            torch.randn(b, 3, generator=g))


def _assert_vanilla_grads(out, ref):
    """d rgb, and d density apart at the last sample (whose 1e10-wide
    interval makes its entries ~1e10 times the others), each within
    BACKWARD_TOL."""
    pairs = [(out[0], ref[0]), (out[1][:, :-1], ref[1][:, :-1]),
             (out[1][:, -1:], ref[1][:, -1:])]
    for o, r in pairs:
        res = kernels.compare(o.contiguous(), r.contiguous(),
                              **RENDER_BWD_TOL)
        assert res["ok"], res


def _plain_vanilla_grads(args, grads, white_bkgd):
    """Autograd of the plain composite on `args`' device (d rgb, d
    density)."""
    leaves = [a.detach().requires_grad_(i < 2) for i, a in enumerate(args)]
    out = composite_vanilla_reference(*leaves, white_bkgd)
    pairs = [(o, g) for o, g in zip(out, grads) if g is not None]
    return torch.autograd.grad([o for o, _ in pairs], leaves[:2],
                               [g for _, g in pairs])


def _assert_ok_where_finite(out, ref, **tol):
    """NaN and inf (with their signs) where the plain version has them,
    and the finite entries within compare()'s tolerance (or `tol`)."""
    finite = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(out), finite)
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert torch.equal(out[torch.isinf(ref)], ref[torch.isinf(ref)])
    res = kernels.compare(out[finite], ref[finite], **tol)
    assert res["ok"], res


def _vanilla_nonfinite(args):
    """Rays 0-3 with a NaN, +inf, zero and huge density at sample 2."""
    rgb, density, t, dirs = (a.clone() for a in args)
    for r, v in enumerate((float("nan"), float("inf"), 0.0, 1e30)):
        density[r, 2, 0] = v
    return rgb, density, t, dirs


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [
    (7, 1), (33, 32), (33, 33), (5, 64), (1, 97), (2048, 65), (2048, 193),
    (512, 65), (512, 129), (256, 129), (256, 193), (6, 256), (6, 257),
    (5, 600), (4229, 65), (4229, 257)])
def test_composite_vanilla_kernel(cuda, b, s):
    """Kernel D against its plain version on the card: S on and around
    the 32-sample run edges, at the staged maximum (256), one past it and
    three segments, at the path's shapes (vanilla 2048 x 65 / 193,
    PixelNeRF 512 x 65 / 129, 256-ray tiles) and at a B past one wave of
    one-ray blocks that 4 rays a block do not divide, white background on
    and off, and rays with NaN / inf / zero / huge densities (non-finite
    where the plain version is)."""
    g = _gen(30)
    args = tuple(a.to(cuda) for a in _vanilla_args(g, b, s))
    if s > 2 and b >= 4:
        args = _vanilla_nonfinite(args)
    before = kernels.launches["composite_vanilla_fwd"]
    for white_bkgd in (False, True):
        ref = composite_vanilla_reference(*args, white_bkgd)
        out = composite_vanilla(*args, white_bkgd)
        for o, r in zip(out, ref):
            _assert_ok_where_finite(o, r)
    assert kernels.launches["composite_vanilla_fwd"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("tiny_last", [False, True])
@pytest.mark.parametrize("b,s", [
    (7, 1), (33, 32), (33, 33), (5, 64), (1, 97), (2048, 65), (2048, 193),
    (512, 65), (512, 129), (6, 256), (6, 257), (5, 600), (4229, 65),
    (4229, 257)])
def test_composite_vanilla_backward_kernel(cuda, b, s, tiny_last):
    """Kernel D' against autograd of the plain version on the card within
    BACKWARD_TOL, white background on and off, with every cotangent and
    with the loss's (rgb alone), also where the last sample's alpha stays
    below 1; S and B as kernel D's card test takes them."""
    g = _gen(31)
    args = tuple(a.to(cuda) for a in _vanilla_args(g, b, s, tiny_last))
    shapes = [o.shape for o in composite_vanilla_reference(*args, False)]
    before = kernels.launches["composite_vanilla_bwd"]
    for white_bkgd in (False, True):
        for subset in (False, True):
            grads = [torch.randn(sh, generator=g).to(cuda)
                     if not subset or k == "rgb" else None
                     for k, sh in zip(VANILLA_OUT_KEYS, shapes)]
            ref = _plain_vanilla_grads(args, grads, white_bkgd)
            out = composite_vanilla_backward(args, grads, white_bkgd)
            _assert_vanilla_grads(out, ref)
    assert kernels.launches["composite_vanilla_bwd"] == before + 4


@pytest.mark.cuda
def test_composite_vanilla_gradients_reach_inputs_through_kernels(cuda):
    """On the card the Function launches D forward and D' backward once
    each, and its gradients are the plain version's."""
    g = _gen(32)
    args = tuple(a.to(cuda) for a in _vanilla_args(g, 64, 65))
    fwd, bwd = (kernels.launches["composite_vanilla_fwd"],
                kernels.launches["composite_vanilla_bwd"])
    rgb, density = (a.clone().requires_grad_() for a in args[:2])
    comp, acc, weights, depth = composite_vanilla(rgb, density, *args[2:])
    cot = torch.randn(comp.shape, generator=g).to(cuda)
    ours = torch.autograd.grad((comp * cot).sum(), [rgb, density])
    ref = _plain_vanilla_grads(args, [cot, None, None, None], False)
    assert (kernels.launches["composite_vanilla_fwd"] - fwd,
            kernels.launches["composite_vanilla_bwd"] - bwd) == (1, 1)
    for o, r in zip(ours, ref):
        assert kernels.compare(o, r, **RENDER_BWD_TOL)["ok"]


@pytest.mark.cuda
def test_composite_vanilla_kernel_rejects_bad_inputs(cuda):
    g = _gen(33)
    rgb, density, t, dirs = (a.to(cuda) for a in _vanilla_args(g, 4, 9))
    with pytest.raises(ValueError, match="float32"):
        composite_vanilla(rgb.double(), density, t, dirs)
    with pytest.raises(ValueError, match="float32"):
        composite_vanilla(rgb[:, :5], density, t, dirs)
    with pytest.raises(ValueError, match="CUDA"):
        composite_vanilla(rgb, density, t.cpu(), dirs)


def test_composite_vanilla_function_grads_match_plain_autograd():
    """CPU: the Function's gradients equal autograd of the plain version
    (the same float32 operations), every output's cotangent given."""
    g = _gen(34)
    args = _vanilla_args(g, 12, 9)
    rgb, density = (a.clone().requires_grad_() for a in args[:2])
    out = composite_vanilla(rgb, density, *args[2:], True)
    cots = [torch.randn_like(o) for o in out]
    loss = sum((o * c).sum() for o, c in zip(out, cots))
    ours = torch.autograd.grad(loss, [rgb, density])
    ref = _plain_vanilla_grads(args, cots, True)
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_composite_vanilla_refuses_gradients_it_does_not_give():
    g = _gen(35)
    args = list(_vanilla_args(g, 4, 5))
    for i, name in ((2, "t_vals"), (3, "dirs")):
        bad = list(args)
        bad[i] = bad[i].clone().requires_grad_()
        with pytest.raises(ValueError, match=name):
            composite_vanilla(*bad)
    with torch.no_grad():
        composite_vanilla(*bad)


def _vanilla_deltas(t, dirs):
    b = t.shape[0]
    dnorm = torch.sqrt(dirs[:, 0] * dirs[:, 0] + dirs[:, 1] * dirs[:, 1]
                       + dirs[:, 2] * dirs[:, 2])
    return torch.cat([(t[:, 1:] - t[:, :-1]) * dnorm[:, None],
                      (torch.full((b, 1), 1e10) * dnorm[:, None])], 1)


def _run_segment(s):
    """Kernels D / D′ and E / E′'s run length K (samples a lane owns) and
    segment (32 K samples loaded at once) for S samples a ray."""
    k = min((s + 31) // 32, 8)
    return k, 32 * k


def _runs(x, k, fill):
    """(B, n) values of a segment as 32 lanes' runs of k (B, 32, k), the
    places past n set to `fill`."""
    out = torch.full((x.shape[0], 32 * k), fill, dtype=torch.float32)
    out[:, :x.shape[1]] = x
    return out.view(-1, 32, k)


def _vanilla_transmittance(alpha):
    """Kernels D / D′'s exclusive transmittance A (B,S), segment by
    segment with a carry: each lane's exclusive products P_j of q = (1 -
    alpha) + 1e-10 along its run, one Hillis-Steele __shfl_up_sync scan of
    the lanes' totals, A = (carry * E_lane) * P_j."""
    b, s = alpha.shape
    k, seg = _run_segment(s)
    out = torch.empty(b, s)
    carry = torch.ones(b)
    for base in range(0, s, seg):
        n = min(seg, s - base)
        q = _runs((1.0 - alpha[:, base:base + n]) + 1e-10, k, 1.0)
        pre = torch.empty(b, 32, k)
        p = torch.ones(b, 32)
        for j in range(k):
            pre[..., j] = p
            p = p * q[..., j]
        for d in (1, 2, 4, 8, 16):
            up = torch.cat([p[:, :d], p[:, :-d]], 1)
            p = torch.where(_LANE >= d, p * up, p)
        excl = torch.cat([torch.ones(b, 1), p[:, :-1]], 1)
        a = (carry[:, None] * excl)[..., None] * pre
        out[:, base:base + n] = a.reshape(b, -1)[:, :n]
        carry = carry * p[:, 31]
    return out


def _run_lane_sum(x):
    """Kernels D and E's sums: each lane's partial along its runs, segment
    after segment, then the __shfl_xor_sync tree."""
    b, s = x.shape
    k, seg = _run_segment(s)
    part = torch.zeros(b, 32)
    for base in range(0, s, seg):
        runs = _runs(x[:, base:base + seg], k, 0.0)
        for j in range(k):
            part = part + runs[..., j]
    return _xor_sum(part)[:, 0]


def _vanilla_reverse(q, c):
    """Kernel D′'s reverse pass: G_i (B,S) from G = 0 past the last
    sample, segment by segment from the last: each lane composes its run's
    maps G -> q G + c from its last sample down, one exclusive
    __shfl_down_sync suffix scan of the lanes' maps applied to the G from
    above gives G at each run's last sample, and the lane walks its run
    down."""
    b, s = q.shape
    k, seg = _run_segment(s)
    out = torch.empty(b, s)
    G = torch.zeros(b)
    for base in range((s - 1) // seg * seg, -1, -seg):
        n = min(seg, s - base)
        qr = _runs(q[:, base:base + n], k, 1.0)
        cr = _runs(c[:, base:base + n], k, 0.0)
        Q, C = torch.ones(b, 32), torch.zeros(b, 32)
        for j in reversed(range(k)):
            C = qr[..., j] * C + cr[..., j]
            Q = qr[..., j] * Q
        for d in (1, 2, 4, 8, 16):
            qd = torch.cat([Q[:, d:], Q[:, -d:]], 1)
            cd = torch.cat([C[:, d:], C[:, -d:]], 1)
            live = _LANE + d < 32
            C, Q = torch.where(live, Q * cd + C, C), torch.where(live, Q * qd,
                                                                 Q)
        qx = torch.cat([Q[:, 1:], torch.ones(b, 1)], 1)
        cx = torch.cat([C[:, 1:], torch.zeros(b, 1)], 1)
        g = qx * G[:, None] + cx
        runs = torch.empty(b, 32, k)
        for j in reversed(range(k)):
            runs[..., j] = g
            g = qr[..., j] * g + cr[..., j]
        out[:, base:base + n] = runs.reshape(b, -1)[:, :n]
        G = Q[:, 0] * G + C[:, 0]
    return out


def _emulate_composite_vanilla(args, white_bkgd):
    """Kernel D in float32, in its order of operations."""
    rgb, density, t, dirs = args
    delta = _vanilla_deltas(t, dirs)
    alpha = 1.0 - torch.exp(-density[..., 0] * delta)
    w = alpha * _vanilla_transmittance(alpha)
    acc = _run_lane_sum(w)
    comp = torch.stack([_run_lane_sum(w * rgb[..., k]) for k in range(3)],
                       -1)
    if white_bkgd:
        comp = comp + (1.0 - acc[:, None])
    return comp, acc, w, _run_lane_sum(w * t)


def _emulate_composite_vanilla_backward(args, grads, white_bkgd):
    """Kernel D' in float32, in its order of operations."""
    rgb, density, t, dirs = args
    b, s = t.shape
    get = lambda g, shape: g if g is not None else torch.zeros(shape)
    gc = get(grads[0], (b, 3))
    ga, gw, gd = get(grads[1], (b,)), get(grads[2], (b, s)), get(grads[3],
                                                                 (b,))
    if white_bkgd:
        ga = ga - (gc[:, 0] + gc[:, 1] + gc[:, 2])
    delta = _vanilla_deltas(t, dirs)
    e = torch.exp(-density[..., 0] * delta)
    alpha = 1.0 - e
    a = _vanilla_transmittance(alpha)
    gi = gw + ga[:, None]
    for k in range(3):
        gi = gi + gc[:, k:k + 1] * rgb[..., k]
    gi = gi + gd[:, None] * t
    G = _vanilla_reverse((1.0 - alpha) + 1e-10, gi * alpha)
    w = (1.0 - e) * a
    return w[..., None] * gc[:, None, :], (a * (gi - G) * e * delta)[..., None]


@pytest.mark.parametrize("tiny_last", [False, True])
@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("s", [1, 5, 31, 32, 33, 65, 97, 129, 193, 256,
                               257, 600])
def test_composite_vanilla_scan_order_fits_tolerance(s, white_bkgd,
                                                     tiny_last):
    """CPU: kernels D and D' in their order of operations (each lane's
    run folded, one exclusive product scan of the lanes, segments of 256
    past S = 256, lane-partial sums in xor-tree order, the lanes' composed
    affine maps and one suffix scan from G = 0) against the plain version and
    its autograd, within the tolerances the card tests hold them to
    (forward: compare()'s 1e-5 relative; backward: BACKWARD_TOL)."""
    g = _gen(36)
    args = _vanilla_args(g, 40, s, tiny_last)
    ref = composite_vanilla_reference(*args, white_bkgd)
    for o, r in zip(_emulate_composite_vanilla(args, white_bkgd), ref):
        _assert_ok(o, r)
    shapes = [o.shape for o in ref]
    for subset in (False, True):
        grads = [torch.randn(sh, generator=g) if not subset or k == "rgb"
                 else None for k, sh in zip(VANILLA_OUT_KEYS, shapes)]
        ref_g = _plain_vanilla_grads(args, grads, white_bkgd)
        out = _emulate_composite_vanilla_backward(args, grads, white_bkgd)
        _assert_vanilla_grads(out, ref_g)


# --- kernels E / E': the MipNeRF-360 composite ----------------------------

def _mip_args(g, b, s, tie=False):
    """density in [0, 10), ascending tdist (B, S+1) in [0.2, 3], dirs
    (unnormalized), rgb. Every ray's last interval is the infinite one
    under opaque_background, and most rays' acc is 1 within an ulp. `tie`:
    ray 0's first density is 1e30, so its weights are (1, 0, ..., 0) and
    acc is exactly 1.0, the tie of max(0, 1 - acc)."""
    t = 0.2 + 2.8 * torch.sort(torch.rand(b, s + 1, generator=g), -1).values
    density = torch.rand(b, s, generator=g) * 10
    if tie:
        density[0, 0] = 1e30
    return (density, t, torch.randn(b, 3, generator=g),
            torch.rand(b, s, 3, generator=g))


def _plain_mip_grads(args, grads, opaque, bg=1.0):
    """Autograd of the plain composite on `args`' device (d density,
    d rgb)."""
    leaves = [a.detach().requires_grad_(i in (0, 3))
              for i, a in enumerate(args)]
    out = composite_mip_reference(*leaves, bg, opaque)
    pairs = [(o, g) for o, g in zip(out, grads) if g is not None]
    wrt = [leaves[0], leaves[3]]
    d = torch.autograd.grad([o for o, _ in pairs], wrt,
                            [g for _, g in pairs], allow_unused=True)
    return [torch.zeros_like(a) if x is None else x for a, x in zip(wrt, d)]


def _assert_mip_grads(out, ref):
    for o, r in zip(out, ref):
        res = kernels.compare(o.contiguous(), r.contiguous(),
                              **MIP_BACKWARD_TOL)
        assert res["ok"], res


def _mip_cots(g, b, s, subset):
    """Cotangents of (weights, rgb, acc, depth): all four, or the
    training path's (`subset`: "weights" for a proposal level, "nerf" for
    the NeRF level's weights and rgb)."""
    shapes = ((b, s), (b, 3), (b,), (b,))
    keep = {"all": MIP_OUT_KEYS, "weights": ("weights",),
            "nerf": ("weights", "rgb")}[subset]
    return [torch.randn(sh, generator=g) if k in keep else None
            for k, sh in zip(MIP_OUT_KEYS, shapes)]


def _sum_scan(x):
    """Kernels E / E′'s transmittance exp(-sum_{j<i} x_j) (B,S), segment by
    segment with a carried sum: each lane's exclusive sums P_j of x along
    its run, one Hillis-Steele __shfl_up_sync additive scan of the lanes'
    totals, T = exp(-((carry + E_lane) + P_j))."""
    b, s = x.shape
    k, seg = _run_segment(s)
    out = torch.empty(b, s)
    carry = torch.zeros(b)
    for base in range(0, s, seg):
        n = min(seg, s - base)
        xr = _runs(x[:, base:base + n], k, 0.0)
        pre = torch.empty(b, 32, k)
        p = torch.zeros(b, 32)
        for j in range(k):
            pre[..., j] = p
            p = p + xr[..., j]
        for d in (1, 2, 4, 8, 16):
            up = torch.cat([p[:, :d], p[:, :-d]], 1)
            p = torch.where(_LANE >= d, p + up, p)
        excl = torch.cat([torch.zeros(b, 1), p[:, :-1]], 1)
        t = torch.exp(-((carry[:, None] + excl)[..., None] + pre))
        out[:, base:base + n] = t.reshape(b, -1)[:, :n]
        carry = carry + p[:, 31]
    return out


def _suffix_sum(v):
    """Kernel E′'s reverse pass: R_i = sum_{k>i} v_k (B,S), segment by
    segment from the last with a carried sum R: each lane's sums of v above
    each interval of its run, one inclusive __shfl_down_sync suffix scan
    of the lanes' totals, R_i = (R + the lanes above) + the run's sum above
    i."""
    b, s = v.shape
    k, seg = _run_segment(s)
    out = torch.empty(b, s)
    R = torch.zeros(b)
    for base in range((s - 1) // seg * seg, -1, -seg):
        n = min(seg, s - base)
        vr = _runs(v[:, base:base + n], k, 0.0)
        above = torch.empty(b, 32, k)
        S = torch.zeros(b, 32)
        for j in reversed(range(k)):
            above[..., j] = S
            S = S + vr[..., j]
        for d in (1, 2, 4, 8, 16):
            dn = torch.cat([S[:, d:], S[:, -d:]], 1)
            S = torch.where(_LANE + d < 32, S + dn, S)
        lanes = torch.cat([S[:, 1:], torch.zeros(b, 1)], 1)
        r = (R[:, None] + lanes)[..., None] + above
        out[:, base:base + n] = r.reshape(b, -1)[:, :n]
        R = R + S[:, 0]
    return out


def _mip_terms(args, opaque):
    density, t, dirs, rgb = args
    dnorm = torch.sqrt(dirs[:, 0] * dirs[:, 0] + dirs[:, 1] * dirs[:, 1]
                       + dirs[:, 2] * dirs[:, 2])
    t0, t1 = t[:, :-1], t[:, 1:]
    delta = (t1 - t0) * dnorm[:, None]
    dd = density * delta
    e = torch.exp(-dd)
    x = dd.clone()
    x[:, -1] = 0.0
    if opaque:
        e[:, -1] = 0.0
    return delta, e, _sum_scan(x), 0.5 * (t1 + t0)


def _emulate_composite_mip(args, bg, opaque):
    """Kernel E in float32, in its order of operations."""
    rgb = args[3]
    _, e, trans, mid = _mip_terms(args, opaque)
    w = (1.0 - e) * trans
    acc = _run_lane_sum(w)
    om = 1.0 - acc
    bg_w = torch.where(torch.isnan(om), om, torch.clamp(om, min=0.0))
    comp = torch.stack([_run_lane_sum(w * rgb[..., k]) + bg_w * bg
                        for k in range(3)], -1)
    return w, comp, acc, _run_lane_sum(w * mid)


def _emulate_composite_mip_backward(args, acc, grads, bg, opaque):
    """Kernel E' in float32, in its order of operations, taking the
    background's branch from `acc`."""
    density, _, _, rgb = args
    b, s = density.shape
    get = lambda g, shape: g if g is not None else torch.zeros(shape)
    gw, gc = get(grads[0], (b, s)), get(grads[1], (b, 3))
    ga, gd = get(grads[2], (b,)), get(grads[3], (b,))
    if grads[1] is not None:
        om = 1.0 - acc
        h = torch.where(om > 0, 1.0, torch.where(om == 0, 0.5, 0.0))
        ga = ga - h * (bg * (gc[:, 0] + gc[:, 1] + gc[:, 2]))
    delta, e, trans, mid = _mip_terms(args, opaque)
    w = (1.0 - e) * trans
    g = gw + ga[:, None]
    for k in range(3):
        g = g + gc[:, k:k + 1] * rgb[..., k]
    g = g + gd[:, None] * mid
    d_density = delta * (g * e * trans - _suffix_sum(g * w))
    if opaque:
        d_density[:, -1] = 0.0
    return d_density, w[..., None] * gc[:, None, :]


@pytest.mark.parametrize("subset", ["all", "weights", "nerf"])
@pytest.mark.parametrize("opaque", [True, False])
@pytest.mark.parametrize("s", [1, 5, 31, 32, 33, 64, 97, 256, 257, 600])
def test_composite_mip_scan_order_fits_tolerance(s, opaque, subset):
    """CPU: kernels E and E' in their order of operations (each lane's run
    folded, one exclusive additive scan of the lanes, segments of 256 past
    S = 256, lane-partial sums in xor-tree order, the lanes' sums above
    each interval and one suffix scan) against the plain version and its
    autograd, within the tolerances the card tests hold them to (forward:
    compare()'s 1e-5 relative; backward: MIP_BACKWARD_TOL). Ray 0 sits
    on the tie acc == 1.0 exactly; with opaque_background most others
    are within an ulp of it, on either side. The emulated E' takes the
    branch from the emulated E's acc and the plain backward from its own:
    the branch shifts every g_i of a ray by one constant, which moves d
    density only by rounding since sum_i w_i is 1."""
    g = _gen(40)
    args = _mip_args(g, 40, s, tie=s > 1)
    ref = composite_mip_reference(*args, 1.0, opaque)
    out = _emulate_composite_mip(args, 1.0, opaque)
    for o, r in zip(out, ref):
        _assert_ok(o, r)
    if opaque and s > 1:
        assert float(ref[2][0]) == 1.0 and float(out[2][0]) == 1.0
    grads = _mip_cots(g, 40, s, subset)
    ref_g = _plain_mip_grads(args, grads, opaque)
    out_g = _emulate_composite_mip_backward(args, out[2], grads, 1.0, opaque)
    _assert_mip_grads(out_g, ref_g)
    if opaque:
        assert torch.all(ref_g[0][:, -1] == 0) and \
            torch.all(out_g[0][:, -1] == 0)


def test_composite_mip_function_grads_match_plain_autograd():
    """CPU: the Function's gradients equal autograd of the plain version
    (the same float32 operations), every output's cotangent given."""
    g = _gen(41)
    args = _mip_args(g, 12, 9, tie=True)
    density, rgb = (args[i].clone().requires_grad_() for i in (0, 3))
    out = composite_mip(density, args[1], args[2], rgb, 1.0, True)
    cots = [torch.randn_like(o) for o in out]
    loss = sum((o * c).sum() for o, c in zip(out, cots))
    ours = torch.autograd.grad(loss, [density, rgb])
    ref = _plain_mip_grads(args, cots, True)
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_composite_mip_refuses_gradients_it_does_not_give():
    g = _gen(42)
    args = list(_mip_args(g, 4, 5))
    for i, name in ((1, "tdist"), (2, "dirs")):
        bad = list(args)
        bad[i] = bad[i].clone().requires_grad_()
        with pytest.raises(ValueError, match=name):
            composite_mip(*bad)
    with torch.no_grad():
        composite_mip(*bad)


def _mip_nonfinite(args):
    """Rays 1-4 with a NaN, +inf, zero and huge density at three places:
    the third interval, the middle one and the last."""
    density, t, dirs, rgb = (a.clone() for a in args)
    s = density.shape[1]
    for r, v in enumerate((float("nan"), float("inf"), 0.0, 1e30), 1):
        density[r, [2, s // 2, s - 1]] = v
    return density, t, dirs, rgb


@pytest.mark.parametrize("opaque", [True, False])
@pytest.mark.parametrize("s", [33, 64, 257])
def test_composite_mip_scan_order_nonfinite(s, opaque):
    """CPU: kernels E and E' in their order of operations give NaN and inf
    where the plain version and its autograd do, and agree with them
    elsewhere (forward: compare()'s 1e-5 relative; backward:
    MIP_BACKWARD_TOL): a lane's sums see only intervals before its own."""
    g = _gen(47)
    args = _mip_nonfinite(_mip_args(g, 8, s, tie=True))
    ref = composite_mip_reference(*args, 1.0, opaque)
    out = _emulate_composite_mip(args, 1.0, opaque)
    for o, r in zip(out, ref):
        _assert_ok_where_finite(o, r)
    grads = _mip_cots(g, 8, s, "all")
    ref_g = _plain_mip_grads(args, grads, opaque)
    out_g = _emulate_composite_mip_backward(args, out[2], grads, 1.0, opaque)
    for o, r in zip(out_g, ref_g):
        _assert_ok_where_finite(o, r, **MIP_BACKWARD_TOL)


MIP_SHAPES = [(7, 1), (33, 32), (33, 33), (5, 64), (1, 97), (2048, 32),
              (2048, 64), (4096, 32), (4096, 64), (6, 256), (6, 257),
              (5, 600), (4229, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", MIP_SHAPES)
def test_composite_mip_kernel(cuda, b, s):
    """Kernel E against its plain version on the card, opaque background
    on and off: S on and around the 32-interval run edges, at the path's
    shapes (2048 x 64 / 32 in training, 4096-ray tiles), at the largest
    single segment (256), one past it and three segments, and at a B that
    no rays-a-block choice divides, with the tie ray (acc exactly 1) and
    every ray's infinite last interval."""
    g = _gen(43)
    args = tuple(a.to(cuda) for a in _mip_args(g, b, s, tie=s > 1))
    before = kernels.launches["composite_mip_fwd"]
    for opaque in (True, False):
        ref = composite_mip_reference(*args, 1.0, opaque)
        out = composite_mip(*args, 1.0, opaque)
        for o, r in zip(out, ref):
            _assert_ok(o, r)
        if opaque and s > 1:
            assert float(out[2][0]) == 1.0
    assert kernels.launches["composite_mip_fwd"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("subset", ["all", "weights", "nerf"])
@pytest.mark.parametrize("b,s", MIP_SHAPES)
def test_composite_mip_backward_kernel(cuda, b, s, subset):
    """Kernel E' against autograd of the plain version on the card within
    MIP_BACKWARD_TOL, opaque background on and off, with every cotangent
    and with the training path's (weights alone; weights and rgb); the
    last interval's density gets exactly zero under opaque_background."""
    g = _gen(44)
    args = tuple(a.to(cuda) for a in _mip_args(g, b, s, tie=s > 1))
    grads = [None if c is None else c.to(cuda)
             for c in _mip_cots(g, b, s, subset)]
    before = kernels.launches["composite_mip_bwd"]
    for opaque in (True, False):
        acc = composite_mip(*args, 1.0, opaque)[2]
        ref = _plain_mip_grads(args, grads, opaque)
        out = composite_mip_backward(args, acc, grads, 1.0, opaque)
        _assert_mip_grads(out, ref)
        if opaque:
            assert torch.all(out[0][:, -1] == 0)
    assert kernels.launches["composite_mip_bwd"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(33, 33), (5, 64), (6, 257), (2048, 64)])
def test_composite_mip_kernels_nonfinite_densities(cuda, b, s):
    """Kernels E and E' with NaN, +inf, zero and huge densities at three
    places of a ray, opaque background on and off: NaN and inf where the
    plain version and its autograd have them, and within their tolerances
    (forward: compare()'s; backward: MIP_BACKWARD_TOL) elsewhere."""
    g = _gen(48)
    args = tuple(a.to(cuda) for a in _mip_nonfinite(_mip_args(g, b, s,
                                                              tie=True)))
    grads = [c.to(cuda) for c in _mip_cots(g, b, s, "all")]
    for opaque in (True, False):
        ref = composite_mip_reference(*args, 1.0, opaque)
        out = composite_mip(*args, 1.0, opaque)
        for o, r in zip(out, ref):
            _assert_ok_where_finite(o, r)
        ref_g = _plain_mip_grads(args, grads, opaque)
        out_g = composite_mip_backward(args, out[2], grads, 1.0, opaque)
        for o, r in zip(out_g, ref_g):
            _assert_ok_where_finite(o, r, **MIP_BACKWARD_TOL)


@pytest.mark.cuda
def test_composite_mip_gradients_reach_inputs_through_kernels(cuda):
    """On the card the Function launches E forward and E' backward once
    each, and its gradients are the plain version's."""
    g = _gen(45)
    args = tuple(a.to(cuda) for a in _mip_args(g, 64, 64, tie=True))
    fwd, bwd = (kernels.launches["composite_mip_fwd"],
                kernels.launches["composite_mip_bwd"])
    density, rgb = (args[i].clone().requires_grad_() for i in (0, 3))
    weights, comp, acc, depth = composite_mip(density, args[1], args[2], rgb)
    cots = [torch.randn(x.shape, generator=g).to(cuda)
            for x in (weights, comp)]
    ours = torch.autograd.grad((weights * cots[0]).sum()
                               + (comp * cots[1]).sum(), [density, rgb])
    ref = _plain_mip_grads(args, cots + [None, None], True)
    assert (kernels.launches["composite_mip_fwd"] - fwd,
            kernels.launches["composite_mip_bwd"] - bwd) == (1, 1)
    _assert_mip_grads(ours, ref)


@pytest.mark.cuda
def test_composite_mip_kernel_rejects_bad_inputs(cuda):
    g = _gen(46)
    density, t, dirs, rgb = (a.to(cuda) for a in _mip_args(g, 4, 9))
    with pytest.raises(ValueError, match="float32"):
        composite_mip(density.double(), t, dirs, rgb)
    with pytest.raises(ValueError, match="float32"):
        composite_mip(density, t[:, :5], dirs, rgb)
    with pytest.raises(ValueError, match="CUDA"):
        composite_mip(density, t.cpu(), dirs, rgb)
