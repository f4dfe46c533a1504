"""The conditioned MLPs' inputs assembled in place
(`models/neo360.py:NeRFTP._inputs`, `_predict`): the tri-plane and local
gathers and `ops/encoding.py:pos_enc_into` write one (NV·B·S, ld) buffer a
branch, columns [world | local | pos_enc], and the MLP's first GEMM reads
its rows where they lie.

On the CPU (plain versions) `NeRFTP.forward` is held to the concatenating
form it replaces, kept here as it was (`_Concatenating`: the latents
returned, pos_enc of [pts | depth] concatenated, [pos_enc | local | world]
concatenated, the weights in the parameters' order): every level's
outputs, the tables' gradients under the dense and the accumulate
contract and the MLPs' parameter gradients, within FUSED_TOL (float32:
only the order of the first GEMM's sums differs; both forms render every
level at the same points, `_resampling`). In bfloat16 the buffer
holds the bits the concatenation rounded, and the outputs and gradients
are held to one bfloat16 rounding, since a reordered float32 sum can round
a bfloat16 activation the other way. Also: no concatenation or copy of
activation size is made in `_predict`; the buffers take their MLPs'
layout (`NeRFTPMLP.columns`, `row_length`); `pos_enc_into` refuses points
that require a gradient; and the per-layer metric
`mlp_inputs_in_place_share.render` reads the kernel's launches in a
profiled view against the view's `model.gather` spans.
"""

from contextlib import contextmanager
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.registry import Registry
from neo360_tpu_torch.core import encoding, sampling
from neo360_tpu_torch.data.fixtures import camera_ring
from neo360_tpu_torch.models.neo360 import NeRFTP
from neo360_tpu_torch.nn.mlp import combine_interleaved
from neo360_tpu_torch.ops import kernels
from neo360_tpu_torch.ops.encoding import pos_enc_into, width
from neo360_tpu_torch.ops.interpolate import FUSED_TOL, build_corner_table, \
    triplane_sample
from neo360_tpu_torch.train import profiling

torch.set_num_threads(1)

NV, RAYS = 3, 6
PLANE_HW, LATENT_HW, IMAGE = (8, 9), (7, 9), (18, 14)
BASE = dict(grid_size=(8, 8, 8), encoder_width=64, num_coarse_samples=7,
            num_fine_samples=6, num_prop_samples=7)
# the model variants the in-place inputs serve
CASES = {
    "neo360_f32": dict(use_proposal=False),
    "neo360_fast_bf16": dict(use_proposal=True, lift_dim=32,
                             compute_dtype=torch.bfloat16),
    "narrow_widths": dict(use_proposal=True, lift_dim=32, plane_dim=32,
                          local_proj_dim=64),
    "one_level": dict(use_proposal=False, num_levels=1),
    "three_levels": dict(use_proposal=False, num_levels=3),
    "view_offsets": dict(use_proposal=False, scenes=2),
}
# one bfloat16 rounding of an activation, relative, and of the largest
# output (see the module docstring)
BF16_TOL = dict(rtol=2.0 ** -7, atol_frac=2.0 ** -7)


class _Concatenating:
    """The assembly this change replaced, as it was: `_inputs` returns
    each branch's (world, local) latents, `_predict` concatenates
    pos_enc([pts | depth]) with them and runs the MLP on the
    concatenation."""

    @staticmethod
    def inputs(model, mlps, cam, rays, plane_tables, plane_hw, local_table,
               latent_hw, image_size, offsets, accs):
        world = triplane_sample(plane_tables, cam, plane_hw,
                                view_offset=offsets[0], grad_acc=accs[0])
        local_fg, local_bg = model._local_feats_pair(
            cam, rays["src_focal"], rays["src_c"], local_table, latent_hw,
            image_size, view_offset=offsets[1], grad_acc=accs[1])
        m = cam.shape[1] // 2
        return (world[:, :m], local_fg), (world[:, m:], local_bg)

    @staticmethod
    def predict(model, mlp, inputs, pts, extra, viewdirs_enc, b, noise=None):
        nv = model.num_src_views
        world_lat, local_lat = inputs
        if extra is not None:
            pts = torch.cat([pts, extra.reshape(1, -1, 1).expand(
                pts.shape[:-1] + (1,))], dim=-1)
        n_samples = pts.shape[1] // b
        x = encoding.pos_enc(pts, model.min_deg_point, model.max_deg_point)
        raw_rgb, raw_sigma = _concat_mlp(
            mlp, x.reshape(nv * b, n_samples, -1),
            viewdirs_enc.reshape(nv * b, -1),
            world_lat.reshape(nv * b, n_samples, -1),
            local_lat.reshape(nv * b, n_samples, -1), nv)
        if noise is not None:
            u = sampling._uniform(raw_sigma.shape, raw_sigma, *noise)
            raw_sigma = raw_sigma + u * model.density_noise
        sigma = F.softplus(raw_sigma + model.density_bias)
        rgb = torch.sigmoid(raw_rgb)
        rgb = rgb * (1 + 2 * model.rgb_padding) - model.rgb_padding
        return rgb, sigma


def _concat_mlp(mlp, x, viewdirs_enc, world_latent, local_latent,
                num_views):
    """NeRFTPMLP.forward as it was: the input concatenated as
    [pos_enc | local | world], the weights in the parameters' order."""
    b, s = x.shape[0] // num_views, x.shape[1]
    dt = mlp.pts_0.dtype
    inputs = torch.cat([x, local_latent, world_latent], dim=-1)
    inputs = inputs.reshape(-1, inputs.shape[-1]).to(dt)
    d_in = inputs.shape[-1]
    heads = [mlp.pts_0] + [mlp._next(idx) for idx in range(mlp.netdepth)
                           if mlp._skip(idx)]
    w = torch.cat([heads[0].weight]
                  + [d.weight[:, -d_in:] for d in heads[1:]])
    bias = torch.cat([d.bias for d in heads])
    blocks = iter(F.linear(inputs, w.to(dt), bias.to(dt)).split(
        [d.weight.shape[0] for d in heads], dim=-1))
    x = F.relu(next(blocks))
    for idx in range(mlp.netdepth):
        if idx == mlp.combine_layer:
            x = combine_interleaved(x, num_views)
            bottleneck = mlp.bottleneck(x)
        dense = mlp._next(idx)
        if mlp._skip(idx):
            x = torch.addmm(next(blocks), x,
                            dense.weight[:, :-d_in].to(dt).t())
        else:
            x = dense(x)
        if idx + 1 < mlp.netdepth:
            x = F.relu(x)
    raw_density = x
    views_0 = mlp.views_0
    w_b, w_c = views_0.weight.split(
        [bottleneck.shape[-1], viewdirs_enc.shape[-1]], dim=1)
    cond = combine_interleaved(F.linear(
        viewdirs_enc.to(dt), w_c.to(dt), views_0.bias.to(dt)), num_views)
    h = F.linear(bottleneck, w_b.to(dt)).view(b, s, -1) + cond[:, None]
    h = F.relu(h)
    for idx in range(1, mlp.netdepth_condition):
        h = F.relu(getattr(mlp, f"views_{idx}")(h))
    return mlp.rgb(h).float(), raw_density.float().view(b, s, -1)


@contextmanager
def _concatenating():
    with mock.patch.object(NeRFTP, "_inputs", _Concatenating.inputs), \
            mock.patch.object(NeRFTP, "_predict", _Concatenating.predict):
        yield


@contextmanager
def _resampling(drawn):
    """Every level's inverse-CDF samples recorded into `drawn` (empty) or,
    once recorded, replayed from it in order, so that both forms render
    a level at the same points: a level's weights differ between them by
    the reordering of the first GEMM's sums, and the next level's inverse
    CDF would move its points by up to 1 / pdf times that."""
    real, replay = sampling.sample_pdf_nerfpp, list(drawn)

    def draw(*a, **kw):
        if replay:
            return replay.pop(0)
        drawn.append(tuple(t.detach() for t in real(*a, **kw)))
        return drawn[-1]

    with mock.patch.object(sampling, "sample_pdf_nerfpp", draw):
        yield
    assert not replay


def _model(case):
    kw = dict(CASES[case])
    kw.pop("scenes", None)
    dt = kw.get("compute_dtype", torch.float32)
    model = NeRFTP(**BASE, **kw, generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():       # biases too, so that every block is live
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g).to(p.dtype))
    return model, dt


def _widths(model):
    """The (plane, local) latents' widths the model was built with, read
    from its parameters' shapes."""
    local = model.local_proj_fg_f.weight.shape[0]
    pe = width(3, model.min_deg_point, model.max_deg_point)
    return model.fg_fine_mlp.in_features - pe - local, local


def _scene(model, dt, scenes, seed=5):
    """Rays from inside the unit sphere, 3 source cameras on a ring, and
    random flat plane and local tables of `scenes` scenes."""
    g = torch.Generator().manual_seed(seed)
    plane_dim, local_dim = _widths(model)
    rays_d = F.normalize(torch.randn(RAYS, 3, generator=g), dim=-1)
    rays = {"rays_o": 0.3 * torch.randn(RAYS, 3, generator=g),
            "rays_d": rays_d, "viewdirs": rays_d,
            "src_imgs": torch.zeros(NV, IMAGE[1], IMAGE[0], 3),
            "src_poses": torch.from_numpy(camera_ring(NV, 1.4, seed)
                                          .astype(np.float32)),
            "src_focal": torch.full((NV,), 16.0) + torch.rand(NV,
                                                              generator=g),
            "src_c": torch.tensor([[9.0, 7.0]]).repeat(NV, 1)
            + torch.rand(NV, 2, generator=g) - 0.5}
    planes = tuple(build_corner_table(torch.randn(
        NV * scenes, *PLANE_HW, plane_dim, generator=g), "zeros",
        dtype=dt) for _ in range(3))
    local = tuple(build_corner_table(torch.randn(
        2 * NV * scenes, *LATENT_HW, local_dim, generator=g),
        "border", dtype=dt) for _ in model.local_names)
    return rays, planes, local


def _run(model, rays, planes, local, scenes, accumulate):
    """Every level's outputs, the tables' gradients (dense: through
    autograd; accumulate: added into f32 accumulators) and the parameters'
    gradients of a fixed random weighting of the outputs."""
    model.zero_grad()
    planes = [t.detach().requires_grad_() for t in planes]
    local = [t.detach().requires_grad_() for t in local]
    accs = [torch.zeros(t.shape) for t in planes + local] \
        if accumulate else None
    local_arg = local[0] if model.use_proposal else tuple(local)
    acc_arg = None
    if accumulate:
        acc_arg = (tuple(accs[:3]), accs[3] if model.use_proposal
                   else tuple(accs[3:]))
    scene = (scenes - 1, scenes) if scenes > 1 else None
    out = model(rays, (tuple(planes), local_arg, None, scene, acc_arg),
                out_depth=True)
    g = torch.Generator().manual_seed(6)
    keys = ("rgb", "fg_rgb", "bg_rgb", "fg_weights", "bg_weights", "depth")
    loss = sum((level[k] * torch.randn(level[k].shape, generator=g)).sum()
               for level in out for k in keys)
    loss.backward()
    tables = accs if accumulate else [t.grad for t in planes + local]
    params = {n: p.grad.clone() for n, p in model.named_parameters()
              if p.grad is not None}
    return ([level[k].detach() for level in out for k in keys], tables,
            params)


@pytest.mark.parametrize("accumulate", [False, True],
                         ids=["dense", "accumulate"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradients_match_the_concatenation(case, accumulate):
    """NeRFTP.forward with the inputs assembled in place against the
    concatenating form (module docstring): outputs, the tables' gradients
    and the parameters' gradients."""
    model, dt = _model(case)
    scenes = CASES[case].get("scenes", 1)
    rays, planes, local = _scene(model, dt, scenes)
    drawn = []
    with _resampling(drawn):
        ours = _run(model, rays, planes, local, scenes, accumulate)
    assert len(drawn) == 2 * (model.num_levels - 1)
    with _concatenating(), _resampling(drawn):
        ref = _run(model, rays, planes, local, scenes, accumulate)
    tol = BF16_TOL if dt == torch.bfloat16 else FUSED_TOL
    assert len(ours[0]) == len(ref[0]) == 6 * model.num_levels
    # a table no level reads (one level's fine local table) gets nothing
    assert [t is None for t in ours[1]] == [t is None for t in ref[1]]
    tables = [(o, r) for o, r in zip(ours[1], ref[1]) if r is not None]
    assert sum(bool(r.abs().max() > 0) for _, r in tables) >= 4
    assert set(ours[2]) == set(ref[2])
    assert sum(n.endswith("mlp.pts_0.weight") for n in ref[2]) >= 2
    pairs = list(zip(ours[0], ref[0])) + tables
    pairs += [(ours[2][n], ref[2][n]) for n in ref[2]]
    for got, want in pairs:
        res = kernels.compare(got.float(), want.float(), **tol)
        assert res["ok"], res


@pytest.mark.parametrize("case", ["neo360_f32", "neo360_fast_bf16"])
def test_the_buffer_holds_the_concatenation_bits(case):
    """Each branch's buffer holds, column for column, the bits of the
    concatenation it replaces (rounded once to the compute dtype), and
    its padding columns hold zeros."""
    model, dt = _model(case)
    rays, planes, local = _scene(model, dt, 1)
    seen = {}
    real = NeRFTP._predict

    def keep(self, mlp, inputs, pts, extra, viewdirs_enc, b, noise=None):
        out = real(self, mlp, inputs, pts, extra, viewdirs_enc, b, noise)
        seen.setdefault("ours", []).append(inputs.clone())
        return out

    def keep_ref(self, mlp, inputs, pts, extra, viewdirs_enc, b, noise=None):
        world, loc = inputs
        x = pts if extra is None else torch.cat([pts, extra.reshape(
            1, -1, 1).expand(pts.shape[:-1] + (1,))], dim=-1)
        x = encoding.pos_enc(x, 0, 10)
        seen.setdefault("ref", []).append(torch.cat(
            [world, loc, x], dim=-1).reshape(-1, x.shape[-1] + world.shape[-1]
                                             + loc.shape[-1]).to(dt))
        return _Concatenating.predict(self, mlp, inputs, pts, extra,
                                      viewdirs_enc, b, noise)

    drawn = []
    with torch.no_grad():
        with mock.patch.object(NeRFTP, "_predict", keep), \
                _resampling(drawn):
            model(rays, (planes, local[0] if model.use_proposal
                         else tuple(local), None))
        with mock.patch.object(NeRFTP, "_inputs", _Concatenating.inputs), \
                mock.patch.object(NeRFTP, "_predict", keep_ref), \
                _resampling(drawn):
            model(rays, (planes, local[0] if model.use_proposal
                         else tuple(local), None))
    assert len(seen["ours"]) == len(seen["ref"]) == 2 * (
        model.num_levels - model.use_proposal)
    for buf, ref in zip(seen["ours"], seen["ref"]):
        d_in = ref.shape[-1]
        assert buf.shape[0] == ref.shape[0]
        assert buf.shape[1] == -(-d_in // (16 // buf.element_size())) \
            * (16 // buf.element_size())
        torch.testing.assert_close(buf[:, :d_in], ref, rtol=0, atol=0)
        assert bool((buf[:, d_in:] == 0).all())


class _Copies(TorchDispatchMode):
    """Records the ops that build a new tensor of concatenated or copied
    values (cat, stack, clone, a dtype copy) with a row per sample: their
    leading sizes multiply to one of `rows`."""
    COPIES = ("cat", "stack", "clone", "_to_copy", "copy")

    def __init__(self, rows):
        super().__init__()
        self.rows, self.seen = rows, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in self.COPIES and isinstance(out, torch.Tensor) \
                and out.dim() and out.numel() // out.shape[-1] in self.rows:
            self.seen.append((name, tuple(out.shape)))
        return out


@pytest.mark.parametrize("grad", [False, True], ids=["render", "train"])
def test_predict_makes_no_concatenation_or_copy(monkeypatch, grad):
    """`_predict` (the encoding written in place and the MLP) hands
    torch.cat no tensor with a row per sample (NV·B·S or B·S rows) and
    copies none (render: inference; train: with autograd)."""
    model, dt = _model("neo360_f32")
    rays, planes, local = _scene(model, dt, 1)
    cats, copies, calls = [], [], []
    cat = torch.cat
    real = NeRFTP._predict

    def counting_cat(tensors, *a, **kw):
        cats.append([t.numel() // t.shape[-1] for t in tensors if t.dim()])
        return cat(tensors, *a, **kw)

    def watched(self, mlp, inputs, *a, **kw):
        rows = (inputs.shape[0], inputs.shape[0] // self.num_src_views)
        calls.append(rows)
        with _Copies(rows) as mode:
            monkeypatch.setattr(torch, "cat", counting_cat)
            try:
                out = real(self, mlp, inputs, *a, **kw)
            finally:
                monkeypatch.setattr(torch, "cat", cat)
        copies.extend(mode.seen)
        return out

    monkeypatch.setattr(NeRFTP, "_predict", watched)
    with torch.set_grad_enabled(grad):
        model(rays, (tuple(t.requires_grad_(grad) for t in planes),
                     tuple(local), None))
    assert len(calls) == 2 * model.num_levels
    per_sample = {n for rows in calls for n in rows}
    assert [c for c in cats if per_sample & set(c)] == [] and copies == []
    assert cats          # the weights' blocks are still joined


@pytest.mark.parametrize("case", ["neo360_f32", "neo360_fast_bf16",
                                  "narrow_widths"])
def test_the_buffers_take_their_mlps_layout(case):
    """Each branch's buffer is as wide as its MLP's `row_length` at 16
    bytes of the buffer's and the tables' types, the latents sit at the
    MLP's `columns` (world first, local next, the encoding last) and the
    encoding is written from the MLP's encoding column."""
    model, dt = _model(case)
    rays, planes, local = _scene(model, dt, 1)
    plane_dim, local_dim = _widths(model)
    seen = []
    real = NeRFTP._predict

    def keep(self, mlp, inputs, *a, **kw):
        seen.append((mlp, inputs.shape[1]))
        return real(self, mlp, inputs, *a, **kw)

    with torch.no_grad(), mock.patch.object(NeRFTP, "_predict", keep):
        model(rays, (planes, local[0] if model.use_proposal
                     else tuple(local), None))
    assert len(seen) == 2 * (model.num_levels - model.use_proposal)
    align = 16 // dt.itemsize
    for mlp, ld in seen:
        assert mlp.columns == (0, plane_dim, plane_dim + local_dim)
        assert ld == mlp.row_length(align) \
            == -(-mlp.in_features // align) * align


@pytest.mark.parametrize("which", ["pts", "extra"])
def test_pos_enc_into_refuses_points_that_take_a_gradient(which):
    """The encoding is written outside autograd, so points or a depth
    channel that require a gradient are refused rather than dropped;
    without grad mode they are written."""
    pts, extra = torch.rand(3, 4, 3), torch.rand(4)
    {"pts": pts, "extra": extra}[which].requires_grad_()
    buf = torch.zeros(12, 88)
    with pytest.raises(ValueError, match="no gradient"):
        pos_enc_into(buf, pts, 4, 0, 10, extra)
    with torch.no_grad():
        pos_enc_into(buf, pts, 4, 0, 10, extra)
    assert bool(buf[:, 4:].abs().sum(1).gt(0).all())


def _in_place_share(kind, trace_launches, gathers):
    """mlp_inputs_in_place_share.render's reading of a run whose profiled
    item (the recorder's last, of `kind`) opened `gathers` model.gather
    spans and whose trace holds `trace_launches` of the encoding kernel
    (None: no trace)."""
    profiling.clear()
    with profiling.item({"view": "render.view", "step": "train.step"}[kind]):
        for _ in range(gathers):
            with profiling.span("model.gather"):
                pass
    trace = None if trace_launches is None else {"kernels": {
        "void pos_enc_into_kernel<float>(float const*, int)": {
            "seconds": 1e-3, "launches": trace_launches},
        "void triplane_sample_kernel<float>(int)": {
            "seconds": 1e-3, "launches": gathers}}}
    try:
        return Registry().reader("mlp_inputs_in_place_share.render").read(
            {"kind": kind, "trace": trace, "items": 1})
    finally:
        profiling.clear()


@pytest.mark.parametrize("kind,launches,gathers,want", [
    ("view", 1200, 600, 100.0),     # every input written in place
    ("view", 900, 600, 75.0),       # one input in four concatenated again
    ("view", 0, 600, None),         # no such kernel (a concatenating program)
    ("view", None, 600, None),      # no trace
    ("step", 4, 2, None),           # training
])
def test_the_in_place_share_reads_launches_against_gathers(kind, launches,
                                                           gathers, want):
    """The per-layer metric: 100 x the encoding kernel's launches in the
    profiled view over two inputs a `model.gather` span of its item."""
    assert _in_place_share(kind, launches, gathers) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("deg", [(0, 10), (0, 4), (2, 5), (3, 3)])
def test_pos_enc_into_reference_is_pos_enc(dtype, deg):
    """The plain `pos_enc_into` writes pos_enc's bits (rounded once to the
    buffer's type) into its columns of view-major rows, from a half of
    the [fg | bg] camera points and with a depth channel shared by the
    views, at large |x| and non-finite points; zeros after them, and the
    columns before them left alone."""
    g = torch.Generator().manual_seed(7)
    nv, n = 3, 40
    cam = torch.randn(nv, 2 * n, 3, generator=g) * 3
    cam[0, 0] = torch.tensor([float("nan"), float("inf"), -1e30])
    cam[1, 1] = torch.tensor([5e4, -2e5, 1e-40])
    extra = torch.rand(n, generator=g)
    for pts, ext in ((cam[:, :n], None), (cam[:, n:], extra)):
        dims = 3 + (ext is not None)
        x = pts if ext is None else torch.cat(
            [pts, ext[None, :, None].expand(nv, n, 1)], -1)
        want = encoding.pos_enc(x, *deg).reshape(nv * n, -1).to(dtype)
        col = 8
        buf = torch.full((nv * n, col + want.shape[1] + 5), 7.0, dtype=dtype)
        got = pos_enc_into(buf, pts, col, *deg, ext)
        assert got is buf
        torch.testing.assert_close(buf[:, col:col + want.shape[1]], want,
                                   rtol=0, atol=0, equal_nan=True)
        assert bool((buf[:, :col] == 7).all())
        assert bool((buf[:, col + want.shape[1]:] == 0).all())
        assert want.shape[1] == dims * (1 + 2 * (deg[1] - deg[0]))
