"""NeO-360 (arXiv:2308.12967) in plain PyTorch: the yardstick that decides
`correct`. It reads its weights from a flat dict keyed as the measured
program's `state_dict()` names them (the interface through which the
benchmark hands both sides the same seeded weights) and computes every
layer with plain torch operations in float32: direct bilinear sampling
(`F.grid_sample`, align_corners) where the program gathers from corner
tables, a direct softmax collapse of the pillars, a `cumprod` composite,
and the inverse-CDF resampling of the JAX reference in its dense-mask form.
It imports nothing of the program, of JAX or of the JAX package.

`Precision` is what the controls lower: "f32" (the reference), "tf32"
(matmuls and convolutions on TF32 tensor cores) and "fp8" (every operand
of a dense layer or convolution rounded to float8 e4m3 with a per-tensor
scale, as a scaled fp8 GEMM would take it). `fault` plants a fault in
the reference put in the program's place (control.py): "rgb" adds 0.05 to
every rendered colour where it is produced; "band" drops the highest
band of every sample's positional encoding; "half" (train.py) leaves
half of every ray batch out of the loss.

Conventions (of the measured model, which follow the JAX package):
images NHWC in [-1, 1]; camera-to-world poses (NV, 4, 4); view 0's focal
and centre project every view; BatchNorm on the batch's own biased
statistics (E[x^2] - E[x]^2), eps 1e-5; the tri-planes are sampled at the
camera coordinates of a point, (x, z), (x, y) and (y, z), with zeros
outside; the pixel latent with border padding.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


@dataclass
class Precision:
    kind: str = "f32"           # f32 | tf32 | fp8
    fault: Optional[str] = None

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind != "fp8":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        q = (x / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x).detach()     # straight-through in the backward

    def linear(self, x, w, b=None):
        return F.linear(self._q(x.float()), self._q(w.float()),
                        None if b is None else b.float())

    def conv(self, x, w, b, stride, pad):
        return F.conv2d(self._q(x.float()), self._q(w.float()),
                        None if b is None else b.float(), stride, pad)


@contextlib.contextmanager
def matmul_precision(p: Precision):
    """TF32 on for matmuls and convolutions only under the "tf32" control,
    off otherwise (cuDNN allows it by default); restored afterwards."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = p.kind == "tf32"
        yield
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


@dataclass
class Arch:
    """The sizes the reference builds from (a configuration file's)."""
    num_src_views: int = 3
    grid_size: Tuple[int, int, int] = (64, 64, 64)
    encoder_width: int = 512
    lift_dim: Optional[int] = None
    pillar_width: int = 512
    depth_fc_layers: int = 2
    plane_hw: Tuple[int, int] = (120, 160)
    use_proposal: bool = False
    num_prop_samples: int = 64
    num_coarse_samples: int = 128
    num_fine_samples: int = 256

    @classmethod
    def from_config(cls, cfg: Dict, **over) -> "Arch":
        keys = cls.__dataclass_fields__
        vals = {k: cfg[k] for k in keys if k in cfg}
        vals.update(over)
        for k in ("grid_size", "plane_hw"):
            vals[k] = tuple(vals[k])
        return cls(**vals)


MIN_DEG, MAX_DEG, DEG_VIEW = 0, 10, 4
FAR_UNCONTRACTED = 3.0
RGB_PADDING = 0.001
DENSITY_BIAS = -1.0
EPS_ALPHA = 1e-10


# ---------------------------------------------------------------- layers

def dense(W: Weights, p: Precision, name: str, x):
    return p.linear(x, W[name + ".weight"], W.get(name + ".bias"))


def conv(W, p, name, x, stride, pad):
    return p.conv(x, W[name + ".weight"], W.get(name + ".bias"), stride, pad)


def batch_norm(W, name, x):
    """Batch statistics over N, H, W (biased, E[x^2] - E[x]^2)."""
    mean = x.mean((0, 2, 3))
    var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + 1e-5) * W[name + ".weight"]
    return (x - mean[:, None, None]) * mul[:, None, None] \
        + W[name + ".bias"][:, None, None]


def up(x, size):
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


def pos_enc(x, min_deg, max_deg):
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=x.dtype,
                                 device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(x.shape[:-1] + (-1,))
    return torch.cat([x, torch.sin(torch.cat([xb, xb + 0.5 * math.pi],
                                             -1))], -1)


def sample_enc(pts, p):
    """A sample's positional encoding; the "band" fault zeroes the sin and
    cos of its highest band (2^(MAX_DEG - 1) x) where they are made."""
    x = pos_enc(pts, MIN_DEG, MAX_DEG)
    if p.fault == "band":
        d, top = pts.shape[-1], MAX_DEG - MIN_DEG - 1
        keep = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
        for half in (0, 1):
            at = d + (half * (top + 1) + top) * d
            keep[at:at + d] = 0
        x = x * keep
    return x


def bilinear(fmap, uv, padding):
    """fmap (V, H, W, C), uv (V, N, 2) in [-1, 1] (x along W) -> (V, N, C),
    align_corners, zeros or border padding."""
    out = F.grid_sample(fmap.permute(0, 3, 1, 2), uv[:, :, None, :],
                        mode="bilinear", padding_mode=padding,
                        align_corners=True)
    return out[..., 0].permute(0, 2, 1)


# --------------------------------------------------------------- geometry

def linspace(start, stop, num, device):
    step = torch.arange(num - 1, dtype=torch.float32, device=device) \
        / (num - 1)
    return torch.cat([start * (1 - step) + stop * step,
                      torch.full((1,), stop, device=device)])


def world2camera(x, c2w):
    """x (NV, N, 3) world -> camera frame of each view: R^T (x - t)."""
    rot = c2w[:, :3, :3].transpose(1, 2)
    trans = -torch.einsum("bij,bj->bi", rot, c2w[:, :3, 3])
    return torch.einsum("bij,bnj->bni", rot, x) + trans[:, None, :]


def project(cam, focal, c):
    """Camera points -> pixels with view 0's (f, -f) and centre."""
    f2 = torch.stack([focal[0], -focal[0]])
    return -cam[..., :2] / (cam[..., 2:] + 1e-9) * f2 + c[0]


def latent_scale(latent_hw, image_wh, device):
    h, w = latent_hw
    s = torch.tensor([w, h], dtype=torch.float32, device=device)
    return s / (s - 1.0) * 2.0 / torch.tensor(image_wh, dtype=torch.float32,
                                              device=device)


def intersect_sphere(o, d):
    d1 = -(d * o).sum(-1, keepdim=True) / (d * d).sum(-1, keepdim=True)
    p = o + d1 * d
    d2 = torch.sqrt(torch.clamp(1.0 - (p * p).sum(-1, keepdim=True),
                                min=0.0)) / torch.linalg.norm(d, dim=-1,
                                                              keepdim=True)
    return d1 + d2


def depth2pts_outside(o, d, depth):
    """NeRF++ inverted-sphere points (B, S, 4) at inverse depths (B, S)."""
    o = o[:, None, :].expand(depth.shape + (3,))
    d = d[:, None, :].expand(depth.shape + (3,))
    norm = lambda v: torch.sqrt((v * v).sum(-1, keepdim=True))
    d1 = -(d * o).sum(-1, keepdim=True) / (d * d).sum(-1, keepdim=True)
    p_mid = o + d1 * d
    p_mid_norm = norm(p_mid)
    d2 = torch.sqrt(torch.clamp(1.0 - p_mid_norm ** 2, min=0.0)) / norm(d)
    p_sphere = o + (d1 + d2) * d
    axis = torch.cross(o, p_sphere, dim=-1)
    axis = axis / (norm(axis) + 1e-10)
    phi = torch.asin(torch.clamp(p_mid_norm, -1.0, 1.0))
    theta = torch.asin(torch.clamp(p_mid_norm * depth[..., None], -1.0, 1.0))
    ang = phi - theta
    p_new = (p_sphere * torch.cos(ang)
             + torch.cross(axis, p_sphere, dim=-1) * torch.sin(ang)
             + axis * (axis * p_sphere).sum(-1, keepdim=True)
             * (1.0 - torch.cos(ang)))
    p_new = p_new / (norm(p_new) + 1e-10)
    return torch.cat([p_new, depth[..., None]], -1)


# ---------------------------------------------------------------- encoder

def resnet34_pixel_latent(W, p, images):
    """ResNet-34 conv1 .. layer3 on NHWC images, the four levels upsampled
    to conv1's size and concatenated -> (NV, H/2, W/2, 512)."""
    pre = "encoder.spatial_encoder.backbone."
    x = images.permute(0, 3, 1, 2)
    x = F.relu(batch_norm(W, pre + "bn1", conv(W, p, pre + "conv1", x, 2,
                                               3)))
    feats = [x]
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, blocks in enumerate((3, 4, 6)):
        for b in range(blocks):
            name = f"{pre}layer{stage + 1}_{b}."
            stride = 2 if (b == 0 and stage > 0) else 1
            y = F.relu(batch_norm(W, name + "bn1",
                                  conv(W, p, name + "conv1", x, stride, 1)))
            y = batch_norm(W, name + "bn2", conv(W, p, name + "conv2", y, 1,
                                                 1))
            if name + "downsample_conv.weight" in W:
                x = batch_norm(W, name + "downsample_bn",
                               conv(W, p, name + "downsample_conv", x,
                                    stride, 0))
            x = F.relu(y + x)
        feats.append(x)
    size = feats[0].shape[-2:]
    return torch.cat([f if f.shape[-2:] == size else up(f, size)
                      for f in feats], 1).permute(0, 2, 3, 1)


def world_grid(grid_size, device):
    axes = [linspace(lo, hi, n, device) for (lo, hi), n in
            zip(((-1.0, 1.0), (-1.0, 1.0), (0.0, 1.0)), grid_size)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)


def encode(W, p, arch: Arch, src):
    """The source stack -> (planes (xz, xy, yz) each (NV, Hp, Wp, Cp),
    local maps [coarse?, fine] each (2NV, H/2, W/2, Cl): rows [:NV] the fg
    branch's projected pixel latent, [NV:] the bg branch's)."""
    imgs, poses = src["src_imgs"], src["src_poses"]
    focal, c = src["src_focal"], src["src_c"]
    nv, h, w = imgs.shape[:3]
    dev = imgs.device
    lat = resnet34_pixel_latent(W, p, imgs)              # (NV, h2, w2, 512)
    gx, gy, gz = arch.grid_size
    grid = world_grid(arch.grid_size, dev)               # (gx, gy, gz, 3)
    pts = grid.reshape(1, -1, 3).expand(nv, -1, 3)
    cam = world2camera(pts, poses)
    mask = (cam[..., 2] < 1e-3).float()
    cam_dir = pts - poses[:, None, :3, 3]
    cam_dir = cam_dir / torch.linalg.norm(cam_dir + 1e-9, dim=-1,
                                          keepdim=True) * mask[..., None]
    uv = project(cam, focal, c) * latent_scale(lat.shape[1:3], (w, h), dev) \
        - 1.0
    lift = lat if arch.lift_dim is None else dense(
        W, p, "encoder.lift_proj", lat)
    feat = bilinear(lift, uv, "zeros")                   # (NV, G, L)
    x = torch.cat([feat, cam, cam_dir], -1)
    for i in range(arch.depth_fc_layers):
        x = F.relu(dense(W, p, f"encoder.depth_fc.fc{i}", x))
    latent = dense(W, p, "encoder.depth_fc.depth", x).reshape(
        nv, gx, gy, gz, arch.encoder_width)
    f = arch.pillar_width
    hid = dense(W, p, "encoder.tri_pillar.hidden_lat", latent)
    cw, hb = W["encoder.tri_pillar.coord_w"], W["encoder.tri_pillar.hidden_b"]
    floors = {}
    for k, (name, axis) in enumerate((("yz", 1), ("xz", 2), ("xy", 3))):
        hk = F.relu(hid[..., k * f:(k + 1) * f] + grid[..., k:k + 1] * cw[k]
                    + hb[k])
        logit = dense(W, p, f"encoder.tri_pillar.out_{name}", hk)[..., 0]
        wts = torch.softmax(logit, dim=axis)
        floors[name] = torch.einsum(
            {1: "nxyz,nxyzc->nyzc", 2: "nxyz,nxyzc->nxzc",
             3: "nxyz,nxyzc->nxyc"}[axis], wts, latent)
    planes = {}
    for name in ("yz", "xz", "xy"):
        pre = f"encoder.floorplan_{name}."
        x = floors[name].permute(0, 3, 1, 2)
        for i, stride in enumerate((2, 2, 1)):
            x = F.relu(batch_norm(W, f"{pre}bn{i}",
                                  conv(W, p, f"{pre}conv{i}", x, stride, 1)))
        x = up(x, (x.shape[-2] * 2, x.shape[-1] * 2))
        x = F.relu(batch_norm(W, pre + "bn3", conv(W, p, pre + "conv3", x, 1,
                                                   1)))
        if tuple(x.shape[-2:]) != arch.plane_hw:
            x = up(x, arch.plane_hw)
        planes[name] = conv(W, p, pre + "conv4", x, 1, 1).permute(0, 2, 3, 1)
    names = ("f",) if arch.use_proposal else ("c", "f")
    local = [torch.cat([dense(W, p, f"local_proj_fg_{n}", lat),
                        dense(W, p, f"local_proj_bg_{n}", lat)], 0)
             for n in names]
    return (planes["xz"], planes["xy"], planes["yz"]), local


# --------------------------------------------------------------- sampling

def stratify(t, gen):
    mids = 0.5 * (t[..., 1:] + t[..., :-1])
    upper = torch.cat([mids, t[..., -1:]], -1)
    lower = torch.cat([t[..., :1], mids], -1)
    u = torch.rand(t.shape, generator=gen, dtype=t.dtype, device=t.device)
    return lower + (upper - lower) * u


def inverse_cdf(bins, weights, n, gen):
    """Piecewise-constant inverse-CDF draws (B, n) from (bins (B, N+1),
    weights (B, N)), in the JAX reference's dense-mask form: the interval
    of each u is the masked max of the bins where u >= cdf and the masked
    min where u < cdf (which, for descending bins, gives the end bins).
    Evenly spaced u without a generator."""
    eps = 1e-5
    wsum = weights.sum(-1, keepdim=True)
    pad = torch.clamp(eps - wsum, min=0.0)
    weights = weights + pad / weights.shape[-1]
    pdf = weights / (wsum + pad)
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], -1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf,
                     torch.ones_like(cdf[..., :1])], -1)
    shape = cdf.shape[:-1] + (n,)
    if gen is None:
        u = linspace(0.0, 1.0 - 2.0 ** -32, n, cdf.device).expand(shape)
    else:
        u = torch.rand(shape, generator=gen, dtype=cdf.dtype,
                       device=cdf.device)
    mask = u[..., None, :] >= cdf[..., :, None]           # (B, N+1, n)

    def interval(x):
        lo = torch.amax(torch.where(mask, x[..., None], x[..., :1, None]), -2)
        hi = torch.amin(torch.where(~mask, x[..., None], x[..., -1:, None]),
                        -2)
        return lo, hi

    b0, b1 = interval(bins)
    c0, c1 = interval(cdf)
    den = c1 - c0
    t = torch.where(den > 0, (u - c0) / torch.where(den == 0,
                                                    torch.ones_like(den),
                                                    den),
                    torch.zeros_like(den))
    t = torch.clamp(torch.nan_to_num(t, nan=0.0), 0.0, 1.0)
    return b0 + t * (b1 - b0)


def level0(o, d, n, near, far, gen):
    """Stratified fg points over [near, far] and bg inverse depths."""
    base = linspace(0.0, 1.0, n + 1, o.device).expand(o.shape[0], n + 1)
    fg_t = near * (1.0 - base) + far * base
    if gen is not None:
        fg_t = stratify(fg_t, gen)
    bg_s = base if gen is None else stratify(base, gen)
    return fg_t, bg_s


def cast(t, o, d):
    return o[:, None, :] + t[..., None] * d[:, None, :]


def bg_points(o, d, far, s_asc):
    """Ascending inverse depths -> (descending s, 4D points, linear pts)."""
    lin = torch.flip(far * (1.0 - s_asc) + FAR_UNCONTRACTED * s_asc, [-1])
    s = torch.flip(s_asc, [-1])
    return s, depth2pts_outside(o, d, s), cast(lin, o, d)


# --------------------------------------------------------------- networks

def nerftp_mlp(W, p, name, x, vd_enc, world, local, nv):
    """Conditioned trunk: 4 x 128 ReLU layers with the input again after
    layer 2, a bottleneck taken before the views are averaged after layer
    3, a density head, and a 2 x 64 view branch averaged after its first
    layer. x, world, local (NV*B, S, .), vd_enc (NV*B, Dv)."""
    x = torch.cat([x, local, world], -1)
    inputs = x
    for i in range(4):
        x = F.relu(dense(W, p, f"{name}.pts_{i}", x))
        if i == 3:
            bottleneck = dense(W, p, f"{name}.bottleneck", x)
            x = x.reshape((nv, -1) + x.shape[1:]).mean(0)
        if i == 2:
            x = torch.cat([x, inputs], -1)
    density = dense(W, p, f"{name}.density", x)
    cond = vd_enc[:, None, :].expand(bottleneck.shape[:-1]
                                     + (vd_enc.shape[-1],))
    h = torch.cat([bottleneck, cond], -1)
    for i in range(2):
        h = dense(W, p, f"{name}.views_{i}", h)
        if i == 0:
            h = h.reshape((nv, -1) + h.shape[1:]).mean(0)
        h = F.relu(h)
    return dense(W, p, f"{name}.rgb", h), density


def prop_mlp(W, p, name, pts):
    x = sample_enc(pts, p)
    for i in range(4):
        x = F.relu(dense(W, p, f"{name}.pts_{i}", x))
    return dense(W, p, f"{name}.density", x)


def composite(rgb, sigma, t, d, far, in_sphere):
    if in_sphere:
        dists = torch.cat([t[..., 1:] - t[..., :-1], far - t[..., -1:]], -1)
        dists = dists * torch.linalg.norm(d[:, None, :], dim=-1)
    else:
        dists = torch.cat([t[..., :-1] - t[..., 1:],
                           torch.full_like(t[..., :1], 1e10)], -1)
    alpha = 1.0 - torch.exp(-sigma[..., 0] * dists)
    trans = torch.cumprod(1.0 - alpha + EPS_ALPHA, -1)
    w = alpha * torch.cat([torch.ones_like(trans[..., :1]),
                           trans[..., :-1]], -1)
    return ((w[..., None] * rgb).sum(-2), w.sum(-1), w, trans[..., -1:],
            (w * t).sum(-1))


def render_rays(W, p, arch: Arch, encoded, src, rays, gen=None,
                scene: int = 0) -> List[Dict[str, torch.Tensor]]:
    """Both levels of a ray batch against `encoded` (a list with one
    `encode` result per scene; `scene` picks it). `gen`: training draws
    (stratified level 0, random inverse-CDF level 1), taken from the
    generator in the measured model's order: fg then bg, level by level;
    None: deterministic. Returns one dict per level."""
    planes, local = encoded[scene]
    nv = arch.num_src_views
    o, d = rays["rays_o"], rays["rays_d"]
    poses, focal, c = src["src_poses"], src["src_focal"], src["src_c"]
    h_img, w_img = src["src_imgs"].shape[1:3]
    b = o.shape[0]
    far = torch.clamp(intersect_sphere(o, d), min=2e-4)
    near = torch.full_like(far, 1e-4)
    vd = torch.einsum("bji,nj->bni", poses[:, :3, :3], rays["viewdirs"])
    vd_enc = pos_enc(vd, 0, DEG_VIEW).reshape(nv * b, -1)
    out = []
    for level in range(2):
        if level == 0:
            n0 = (arch.num_prop_samples if arch.use_proposal
                  else arch.num_coarse_samples)
            fg_t, bg_s = level0(o, d, n0, near, far, gen)
            bg_t, bg_pts4, bg_lin = bg_points(o, d, far, bg_s)
        else:
            prev = out[-1]
            pad = 0.01 if arch.use_proposal else 0.0
            n1 = arch.num_fine_samples + (1 if arch.use_proposal else 0)
            fg_new = inverse_cdf(0.5 * (fg_t[..., 1:] + fg_t[..., :-1]),
                                 prev["fg_weights"][..., 1:-1].detach()
                                 + pad, n1, gen).detach()
            bg_new = inverse_cdf(0.5 * (bg_t[..., 1:] + bg_t[..., :-1]),
                                 prev["bg_weights"][..., 1:-1].detach()
                                 + pad, n1, gen).detach()
            if not arch.use_proposal:
                fg_new = torch.cat([fg_t, fg_new], -1)
                bg_new = torch.cat([bg_t, bg_new], -1)
            fg_t = torch.sort(fg_new, -1).values
            bg_t, bg_pts4, bg_lin = bg_points(
                o, d, far, torch.sort(bg_new, -1).values)
        fg_pts = cast(fg_t, o, d)
        if arch.use_proposal and level == 0:
            fg_sigma = F.softplus(prop_mlp(W, p, "fg_prop_mlp", fg_pts)
                                  + DENSITY_BIAS)
            bg_sigma = F.softplus(prop_mlp(W, p, "bg_prop_mlp", bg_pts4)
                                  + DENSITY_BIAS)
            fg_rgb = torch.zeros(fg_sigma.shape[:-1] + (3,), device=o.device)
            bg_rgb = torch.zeros(bg_sigma.shape[:-1] + (3,), device=o.device)
        else:
            which = "coarse" if level == 0 else "fine"
            tab = 0 if arch.use_proposal else level
            s = fg_t.shape[1]
            pts = torch.cat([fg_pts, bg_lin], 0).reshape(1, -1, 3)
            cam = world2camera(pts.expand(nv, -1, 3), poses)  # (NV, 2BS, 3)
            xz, xy, yz = planes
            world = (bilinear(xz, cam[..., [0, 2]], "zeros")
                     + bilinear(xy, cam[..., [0, 1]], "zeros")
                     + bilinear(yz, cam[..., [1, 2]], "zeros"))
            uv = project(cam, focal, c) * latent_scale(
                local[tab].shape[1:3], (w_img, h_img), o.device) - 1.0
            m = b * s
            loc = bilinear(local[tab], torch.cat([uv[:, :m], uv[:, m:]], 0),
                           "border")
            bg_cam = world2camera(bg_pts4[..., :3].reshape(1, -1, 3).expand(
                nv, -1, 3), poses)
            bg_cam4 = torch.cat([bg_cam, bg_pts4[..., 3].reshape(1, -1, 1)
                                 .expand(nv, -1, 1)], -1)
            res = []
            for branch, pts_c, wl, ll in (
                    ("fg", cam[:, :m], world[:, :m], loc[:nv]),
                    ("bg", bg_cam4, world[:, m:], loc[nv:])):
                x = sample_enc(pts_c, p)
                raw_rgb, raw_sigma = nerftp_mlp(
                    W, p, f"{branch}_{which}_mlp", x.reshape(nv * b, s, -1),
                    vd_enc, wl.reshape(nv * b, s, -1),
                    ll.reshape(nv * b, s, -1), nv)
                rgb = torch.sigmoid(raw_rgb) * (1 + 2 * RGB_PADDING) \
                    - RGB_PADDING
                res.append((rgb, F.softplus(raw_sigma + DENSITY_BIAS)))
            (fg_rgb, fg_sigma), (bg_rgb, bg_sigma) = res
        fg_comp, fg_acc, fg_w, bg_lambda, fg_depth = composite(
            fg_rgb, fg_sigma, fg_t, d, far, True)
        bg_comp, bg_acc, bg_w, _, bg_depth = composite(
            bg_rgb, bg_sigma, bg_t, d, far, False)
        rgb = fg_comp + bg_lambda * bg_comp
        if p.fault == "rgb":
            rgb = rgb + 0.05
        fg_mid = 0.5 * (fg_t[..., 1:] + fg_t[..., :-1])
        out.append({
            "rgb": rgb, "depth": fg_depth + bg_lambda[..., 0] * bg_depth,
            "fg_weights": fg_w, "bg_weights": bg_w, "fg_tvals": fg_t,
            "bg_tvals": bg_t, "far": far,
            "fg_sdist": torch.cat([fg_mid, fg_mid[..., -1:] + (
                fg_mid[..., -1:] - fg_mid[..., -2:-1])], -1),
            "bg_sdist": torch.cat([0.5 * (bg_t[..., 1:] + bg_t[..., :-1]),
                                   bg_t[..., -1:]], -1)})
    return out


# ------------------------------------------------------------------ losses

def _outer(t0, t1, y1):
    """Outer measure of the t0 intervals under the histogram (t1, y1)."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, -1)],
                    -1)
    i = torch.arange(t1.shape[-1], device=t1.device)
    ge = t0[..., None, :] >= t1[..., :, None]
    lo = torch.amax(torch.where(ge, i[:, None], i[:1, None]), -2)
    hi = torch.amin(torch.where(~ge, i[:, None], i[-1:, None]), -2)
    return torch.gather(cy1, -1, hi)[..., 1:] \
        - torch.gather(cy1, -1, lo)[..., :-1]


def _lossfun_outer(t, w, t_env, w_env):
    return torch.clamp(w - _outer(t, t_env, w_env), min=0.0) ** 2 \
        / (w + 1.1920929e-07)


def _distortion(w, m, interval):
    cw = torch.cumsum(w, -1) - w
    cwm = torch.cumsum(w * m, -1) - w * m
    return torch.mean(2.0 * (w * (m * cw - cwm)).sum(-1)
                      + (w * w * interval).sum(-1) / 3.0)


def loss(arch: Arch, out, target):
    """(training loss, fine MSE): fine MSE + interlevel + distortion with
    the proposal; coarse MSE + fine MSE + distortion without."""
    fine = out[-1]
    mse = lambda x: torch.mean((x - target) ** 2)
    n = fine["fg_weights"].shape[-1]
    dist = 0.01 * _distortion(fine["fg_weights"], fine["fg_sdist"], 1.0 / n) \
        + 0.01 * _distortion(torch.flip(fine["bg_weights"], [-1]),
                             torch.flip(fine["bg_sdist"], [-1]), 1.0 / n)
    l1 = mse(fine["rgb"])
    if not arch.use_proposal:
        return mse(out[0]["rgb"]) + l1 + dist, l1
    prop = out[0]
    edges_fg = lambda r: torch.cat([r["fg_tvals"], torch.maximum(
        r["far"], r["fg_tvals"][..., -1:])], -1)

    def edges_bg(r):
        a = torch.flip(r["bg_tvals"], [-1])
        return torch.cat([a[..., :1] - 1e-3, a], -1)

    inter = torch.mean(_lossfun_outer(
        edges_fg(fine).detach(), fine["fg_weights"].detach(),
        edges_fg(prop), prop["fg_weights"]))
    inter = inter + torch.mean(_lossfun_outer(
        edges_bg(fine).detach(),
        torch.flip(fine["bg_weights"], [-1]).detach(), edges_bg(prop),
        torch.flip(prop["bg_weights"], [-1])))
    return l1 + inter + dist, l1
