"""PixelNeRF (Yu et al. 2021, arXiv:2012.02190; code github.com/sxyu/
pixel-nerf, `conf/default_mv.conf` as `conf/exp/dtu.conf` trains it with
`-V 3`) in plain PyTorch: the yardstick that decides `correct` for the
`pixelnerf` configuration. It reads its weights from a flat dict keyed as
the measured program's `state_dict()` names them (`encoder.backbone.*`,
`coarse_mlp.lin_in.weight`, ..., `fine_mlp.lin_out.bias`) and computes
every step in float32 from the published code's equations, in its order:

- the encoder: ResNet-34 through layer3 on every source image of every
  scene at once, BatchNorm on the batch's statistics, the maps of conv1
  and layers 1-3 upsampled to H/2 x W/2 (bilinear, align_corners) and
  concatenated: a 512-channel latent (`reference/model.py`);
- each sample x of a scene, for each of its source views with
  world-to-camera rotation R and translation t: the encoded input
  [PE(R x), R d] (pixel-nerf's `normalize_z`: the rotation alone), PE
  with 6 frequencies 1.5 * 2^i, input first and the sin and cos of each
  frequency side by side, d the ray's unit direction; the latent at the
  projection of R x + t with (f, -f) and the scene's centre, bilinear with
  border padding (`F.grid_sample`);
- `ResnetFC`: x = lin_in(input); for blocks i = 0..4, the mean over the
  scene's views before block 3, x += lin_z[i](latent) for i < 3, x = x +
  fc_1(relu(fc_0(relu(x)))); lin_out(relu(x)): sigmoid rgb, ReLU density;
- the renderer: 64 coarse depths, one uniformly inside each equal bin of
  [near, far]; the fine level's 16 bins drawn from the coarse weights +
  1e-5 by searchsorted with a uniform depth inside each, and 16 depths at
  the coarse depth + N(0, 0.01^2) clamped to [near, far]; the 96 sorted,
  the fine network on all of them; the composite with deltas of the
  depths, the last 1e10, T the cumulative product of 1 - alpha + 1e-10;
- the loss: coarse MSE + fine MSE; Adam (0.9, 0.999, 1e-8) at a constant
  learning rate, no clip (`reference/train.py:Adam`).

The generator's draws are taken in the published order, per step: the
coarse uniforms (rays, 64), the bins' uniforms (rays, 16), the in-bin
uniforms (rays, 16), the depth normals (rays, 16), rays scene-major.

Departures from pixel-nerf, each the measured program's (so both sides
agree; none changes the work), written where they act: the depth samples
are drawn around the detached coarse depth; the projection divides by z +
1e-9; near / far are the port's 0.02 / 3.0 of the NERDS360-style scenes
(DTU's: 0.1 / 5.0).

`fault` plants a fault in the reference put in the program's place
(control.py): "half" leaves half of every scene's rays out of the loss;
"combine" averages the views after block 4 (before block index 4) rather
than after block 3, with the latent still added into blocks 0-2. `kind`
"tf32" computes every matmul and convolution on TF32 tensor cores
(`reference/model.py:matmul_precision`). Nothing of the measured program,
of JAX or of the JAX package is imported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train

Weights = Dict[str, torch.Tensor]
FAULTS = ("half", "combine")
SRC_KEYS = ("src_imgs", "src_poses", "src_focal", "src_c")
ENCODER = "encoder."            # the program's name of its SpatialEncoder


@dataclass
class Arch:
    """The sizes and constants the reference builds from (a configuration
    file's keys of the same names)."""
    num_src_views: int = 3
    mlp_blocks: int = 5
    mlp_width: int = 512
    combine_layer: int = 3
    pos_freqs: int = 6
    pos_freq_factor: float = 1.5
    num_coarse_samples: int = 64
    num_fine_samples: int = 32
    num_fine_depth_samples: int = 16
    depth_std: float = 0.01
    near: float = 0.02
    far: float = 3.0
    lr: float = 1e-4

    @classmethod
    def from_config(cls, cfg: Dict) -> "Arch":
        return cls(**{k: cfg[k] for k in cls.__dataclass_fields__
                      if k in cfg})


# ------------------------------------------------------------ the encoder

def pixel_latent(W: Weights, p, images):
    """(N, H, W, 3) images in [-1, 1] -> (N, H/2, W/2, 512), the program's
    encoder weights read under reference/model.py's names."""
    named = {"encoder.spatial_encoder." + k[len(ENCODER):]: v
             for k, v in W.items() if k.startswith(ENCODER)}
    return ref_model.resnet34_pixel_latent(named, p, images)


def pos_enc(x, num_freqs: int, factor: float):
    """[x, sin(f_0 x), cos(f_0 x), ...], f_i = factor 2^i: pixel-nerf's
    PositionalEncoding, sin(phase + x f) by `addcmul`, phases 0, pi/2."""
    freqs = factor * 2.0 ** torch.arange(num_freqs, dtype=x.dtype,
                                         device=x.device)
    freqs = torch.repeat_interleave(freqs, 2)[:, None]
    phases = torch.zeros(2 * num_freqs, dtype=x.dtype, device=x.device)
    phases[1::2] = math.pi * 0.5
    embed = torch.sin(torch.addcmul(phases[:, None], x[..., None, :], freqs))
    return torch.cat([x, embed.flatten(-2)], -1)


# ---------------------------------------------------------------- the MLP

def dense(W: Weights, p, name: str, x):
    return p.linear(x, W[name + ".weight"], W[name + ".bias"])


def resnetfc(W: Weights, p, prefix: str, x, z, arch: Arch, mean_at: int):
    """x (SB, NV, N, d_in) inputs and z (SB, NV, N, 512) latents ->
    (SB, N, 4): the views averaged before block `mean_at`, the latent
    added into the blocks before `arch.combine_layer`."""
    x = dense(W, p, f"{prefix}.lin_in", x)
    for i in range(arch.mlp_blocks):
        if i == mean_at:
            x = x.mean(1)
        if i < min(arch.combine_layer, mean_at):
            x = x + dense(W, p, f"{prefix}.lin_z.{i}", z)
        block = f"{prefix}.blocks.{i}"
        h = dense(W, p, f"{block}.fc_0", F.relu(x))
        x = x + dense(W, p, f"{block}.fc_1", F.relu(h))
    return dense(W, p, f"{prefix}.lin_out", F.relu(x))


# ------------------------------------------------------------ the renderer

def composite(rgb, sigma, z):
    """(rgb (B, 3), weights (B, K), depth (B,)) of raw rgb (B, K, 3) and
    density (B, K) at depths z (B, K)."""
    deltas = z[:, 1:] - z[:, :-1]
    deltas = torch.cat([deltas, 1e10 * torch.ones_like(deltas[:, :1])], -1)
    alphas = 1 - torch.exp(-deltas * torch.relu(sigma))
    shifted = torch.cat([torch.ones_like(alphas[:, :1]),
                         1 - alphas + 1e-10], -1)
    weights = alphas * torch.cumprod(shifted, -1)[:, :-1]
    return ((weights[..., None] * rgb).sum(-2), weights,
            (weights * z).sum(-1))


def sample_fine(weights, n: int, near: float, far: float, gen):
    """Bins drawn from the coarse weights (+ 1e-5), a uniform depth inside
    each."""
    weights = weights.detach() + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)],
                    -1)
    u = torch.rand((weights.shape[0], n), generator=gen, dtype=pdf.dtype,
                   device=pdf.device)
    inds = torch.searchsorted(cdf, u, right=True).float() - 1.0
    inds = torch.clamp_min(inds, 0.0)
    z = (inds + torch.rand(inds.shape, generator=gen, dtype=inds.dtype,
                           device=inds.device)) / weights.shape[-1]
    return near * (1 - z) + far * z


def sample_fine_depth(depth, n: int, std: float, near: float, far: float,
                      gen):
    """The coarse depth + N(0, std^2), clamped to [near, far]; drawn
    around the detached depth (departure: pixel-nerf keeps it attached,
    so its fine loss reaches the coarse network through these depths)."""
    z = depth.detach().unsqueeze(1).repeat((1, n))
    z = z + torch.randn(z.shape, generator=gen, dtype=z.dtype,
                        device=z.device) * std
    return torch.max(torch.min(z, torch.full_like(z, far)),
                     torch.full_like(z, near))


def level(W: Weights, p, arch: Arch, prefix: str, latent, src, o, d, z,
          mean_at: int):
    """One level's (rgb (B, 3), weights (B, K), depth (B,)) at depths z
    (B, K) of the rays o, d (SB, R, 3), B = SB * R, against each scene's
    latent (SB, NV, h, w, 512)."""
    sb, r = o.shape[:2]
    k = z.shape[-1]
    poses, focal, c = src["src_poses"], src["src_focal"], src["src_c"]
    h_img, w_img = src["src_imgs"].shape[2:4]
    pts = (o.reshape(-1, 1, 3) + z[..., None] * d.reshape(-1, 1, 3)
           ).reshape(sb, r * k, 3)
    rot = poses[..., :3, :3].transpose(-1, -2)            # world to camera
    trans = -(rot @ poses[..., :3, 3:])[..., 0]            # (SB, NV, 3)
    xyz_rot = torch.einsum("svij,snj->svni", rot, pts)     # (SB, NV, N, 3)
    xyz = xyz_rot + trans[:, :, None, :]
    scale = ref_model.latent_scale(latent.shape[2:4], (w_img, h_img),
                                   o.device)
    feats = torch.stack([
        ref_model.bilinear(latent[s], ref_model.project(
            xyz[s], focal[s], c[s]) * scale - 1.0, "border")
        for s in range(sb)])                                # (SB, NV, N, L)
    dirs = torch.einsum("svij,srj->svri", rot, d)           # (SB, NV, R, 3)
    dirs = dirs[:, :, :, None, :].expand(-1, -1, -1, k, -1).reshape(
        xyz.shape)
    x = torch.cat([pos_enc(xyz_rot, arch.pos_freqs, arch.pos_freq_factor),
                   dirs], -1)
    out = resnetfc(W, p, prefix, x, feats, arch, mean_at).reshape(
        sb * r, k, 4)
    return composite(torch.sigmoid(out[..., :3]), out[..., 3], z)


def render(W: Weights, p, arch: Arch, src, rays, gen, fault=None):
    """[coarse, fine] (rgb (B, 3), weights, depth) of the rays (SB, R, 3)
    of SB scenes with source stacks src (SB, NV, ...), B = SB * R."""
    sb, nv, h, w = src["src_imgs"].shape[:4]
    latent = pixel_latent(W, p, src["src_imgs"].reshape(sb * nv, h, w, 3))
    latent = latent.reshape((sb, nv) + latent.shape[1:])
    o, d = rays["rays_o"], rays["viewdirs"]
    n_rays = o.shape[0] * o.shape[1]
    mean_at = arch.combine_layer + (1 if fault == "combine" else 0)
    kc = arch.num_coarse_samples
    step = 1.0 / kc
    z = torch.linspace(0, 1 - step, kc, device=o.device).unsqueeze(0) \
        .repeat(n_rays, 1)
    z = z + torch.rand(z.shape, generator=gen, dtype=z.dtype,
                       device=z.device) * step
    z_coarse = arch.near * (1 - z) + arch.far * z
    coarse = level(W, p, arch, "coarse_mlp", latent, src, o, d, z_coarse,
                   mean_at)
    n_depth = arch.num_fine_depth_samples
    z_fine = torch.sort(torch.cat([
        z_coarse,
        sample_fine(coarse[1], arch.num_fine_samples - n_depth, arch.near,
                    arch.far, gen),
        sample_fine_depth(coarse[2], n_depth, arch.depth_std, arch.near,
                          arch.far, gen)], -1), -1).values
    fine = level(W, p, arch, "fine_mlp", latent, src, o, d, z_fine, mean_at)
    return [coarse, fine]


# ------------------------------------------------------------ the trainer

class Trainer:
    """Per-step training over a batch of scenes: each item is SB scenes'
    source stacks and R rays of each; the two levels' MSE, its gradient
    with respect to every parameter, one Adam step (no clip) at the
    constant learning rate."""

    def __init__(self, arch: Arch, weights: Weights, kind: str = "f32",
                 fault=None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault {fault!r}: one of {FAULTS}")
        self.arch, self.fault = arch, fault
        self.prec = ref_model.Precision(kind)
        self.W = {k: v.detach().float().clone().requires_grad_()
                  for k, v in weights.items()}
        self.opt = ref_train.Adam(list(self.W.values()), math.inf,
                                  lambda count: arch.lr)

    def moments(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.W, self.opt.mu))

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.W.items()}

    def loss(self, item, gen) -> torch.Tensor:
        if self.fault == "half":       # half of every scene's rays left out
            n = item["rays_o"].shape[1] // 2
            item = {k: v if k in SRC_KEYS else v[:, :n]
                    for k, v in item.items()}
        src = {k: item[k] for k in SRC_KEYS}
        out = render(self.W, self.prec, self.arch, src, item, gen,
                     self.fault)
        target = item["target"].reshape(-1, 3)
        return sum(torch.mean((rgb - target) ** 2) for rgb, _, _ in out)

    def step(self, item, gen) -> float:
        with ref_model.matmul_precision(self.prec):
            value = self.loss(item, gen)
            grads = torch.autograd.grad(value, list(self.W.values()),
                                        allow_unused=True)
        self.opt.step([torch.zeros_like(w) if g is None else g
                       for g, w in zip(grads, self.W.values())])
        return float(value.detach())

