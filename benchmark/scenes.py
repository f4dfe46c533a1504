"""The benchmark's traffic generator: synthetic NERDS360-style scenes and
the few-shot samplers that feed the trainers and the renderer, all drawn
from one seed. A frozen copy of the fixture scene (a shaded sphere under a
direction-gradient sky, cameras on a jittered ring looking at the origin,
8-bit colours) and of the NERDS360_AE stage and step ray sampling, so that
the yardstick does not move with the program's own loaders.

A traffic mix is a JSON file under `traffic/` (registry.py reads it); its
`kind` picks the item the window repeats. Few-shot mixes (a source stack
and rays of other views of the same scene):
- "stage": S distinct scenes of the pool, each with 3 random source views
  of its train cameras, and K steps of B rays (B / S from each scene),
  each step's rays across up to `dest_views_per_sample` of the other
  views: the scene-mixed stage trainer's batch;
- "step": one random scene, 3 random source views and B rays across up
  to `dest_views_per_sample` other views: the per-step trainer's batch;
- "view": one scene's fixed source views [0, 38, 44] and the full images
  of its `orbit_views` held-out orbit cameras, one ray per pixel. Every
  seed has the same orbit, evenly spaced at one elevation
  (`orbit_elevation_deg`), in an order of its own, so that the seed
  changes the scene's source cameras and the weights but not the set of
  views a window draws from.
Per-scene mixes (a model trained on one scene's ring views; every ray
carries `radii`, the base radius of its pixel's cone, 2 / (focal x
sqrt(12)) for these pinhole cameras, from which MipNeRF casts its
cones):
- "rays": B rays of scene 0 of the pool, each at a random train view and
  pixel, with their target colours: a per-scene trainer's step;
- "image": scene 0's `orbit_views` held-out orbit views, whole, as
  "view" draws them, with no source stack.
To the harness an item is a training step ("step", "rays"), a stage
("stage") or a view to render ("view", "image"): the pool's `kind`.

Scenes are rendered in bulk on the given device; items are assembled on
the device and handed back as host tensors (pinned on a CUDA run), which
the harness copies to the card inside the window, as the CLI's prefetch
does. The same seed gives the same items.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

SPHERE_RADIUS_FRAC = 0.35       # of the camera ring's radius
SRC_VIEWS_ORBIT = (0, 38, 44)   # the NERDS360 eval protocol's 3 sources
SRC_KEYS = ("src_imgs", "src_poses", "src_focal", "src_c")
RAY_KEYS = ("rays_o", "rays_d", "viewdirs")
ROLE = {"stage": "stage", "step": "step", "view": "view", "rays": "step",
        "image": "view"}


def _ring(az: np.ndarray, el: np.ndarray, radius: float) -> np.ndarray:
    pos = radius * np.stack([np.cos(az) * np.cos(el),
                             np.sin(az) * np.cos(el), np.sin(el)], -1)
    return np.stack([_look_at(p) for p in pos])


def _look_at(position: np.ndarray) -> np.ndarray:
    """OpenGL c2w looking at the origin, z up."""
    z = position / np.linalg.norm(position)
    x = np.cross([0.0, 0.0, 1.0], z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, position
    return c2w


def camera_ring(rng: np.random.Generator, n: int, radius: float
                ) -> np.ndarray:
    """n cameras on a jittered upper hemisphere looking at the origin."""
    if n == 0:
        return np.zeros((0, 4, 4))
    az = 2 * np.pi * np.arange(n) / n + rng.uniform(-0.05, 0.05, n)
    el = np.deg2rad(rng.uniform(15.0, 55.0, n))
    return _ring(az, el, radius)


def orbit(n: int, radius: float, elevation_deg: float) -> np.ndarray:
    """n cameras evenly spaced on a circle at one elevation, half a step
    off the ring's azimuths, looking at the origin."""
    if n == 0:
        return np.zeros((0, 4, 4))
    az = 2 * np.pi * (np.arange(n) + 0.5) / n
    return _ring(az, np.full(n, np.deg2rad(elevation_deg)), radius)


def pixel_rays(c2w: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
               wh, focal: float):
    """Rays through pixel corners: c2w (N, 4, 4) or (4, 4), xs / ys (N,)
    -> rays_o, rays_d, viewdirs, each (N, 3) float32."""
    w, h = wh
    dirs = torch.stack([(xs - w / 2.0) / focal, -(ys - h / 2.0) / focal,
                        -torch.ones_like(xs)], -1).double()
    rot = c2w[..., :3, :3].double()
    rays_d = torch.einsum("...ij,...j->...i", rot, dirs)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = c2w[..., :3, 3].double().expand(rays_d.shape)
    return rays_o.float(), rays_d.float(), viewdirs.float()


def render(c2w: torch.Tensor, wh, focal: float, sphere_radius: float
           ) -> torch.Tensor:
    """Every pixel of every camera c2w (V, 4, 4): (V, H, W, 3) uint8, the
    sphere shaded by its normal and the sky by the ray's direction."""
    w, h = wh
    dev = c2w.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev),
                            torch.arange(w, dtype=torch.float64, device=dev),
                            indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    out = []
    for cam in c2w:
        o, d, _ = pixel_rays(cam.expand(xs.shape + (4, 4)), xs, ys, wh,
                             focal)
        o, d = o.double(), d.double()
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        b = (d * o).sum(-1)
        disc = b * b - ((o * o).sum(-1) - sphere_radius ** 2)
        t_hit = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        hit = (disc > 0) & (t_hit > 0)
        p = o + t_hit[:, None] * d
        normal = p / (torch.linalg.norm(p, dim=-1, keepdim=True) + 1e-12)
        sky = 0.55 + 0.4 * (0.5 + 0.5 * d) * torch.tensor(
            [0.4, 0.55, 0.9], dtype=torch.float64, device=dev)
        rgb = torch.where(hit[:, None], 0.5 + 0.5 * normal, sky)
        out.append((torch.clamp(rgb, 0, 1) * 255).to(torch.uint8)
                   .reshape(h, w, 3))
    return torch.stack(out)


class ScenePool:
    """`n_scenes` scenes of `n_views` ring cameras each (poses normalized
    by the largest camera distance, as the NERDS360 loader does), with
    `orbit_views` held-out cameras on an orbit at `orbit_elevation_deg`,
    rendered on `device`."""

    def __init__(self, seed: int, n_scenes: int, n_views: int, wh,
                 radius: float, device, orbit_views: int = 0,
                 orbit_elevation_deg: float = 35.0):
        rng = np.random.default_rng([seed, 7])
        self.wh = tuple(wh)
        self.focal = 1.1 * self.wh[0]
        self.c = torch.tensor([self.wh[0] / 2.0, self.wh[1] / 2.0])
        self.device = torch.device(device)
        self.poses, self.images, self.orbit = [], [], []
        for _ in range(n_scenes):
            ring = camera_ring(rng, n_views, radius)
            orbit_c2w = orbit(orbit_views, radius, orbit_elevation_deg)
            scale = 1.0 / np.max(np.abs(ring[:, :3, 3]))
            ring[:, :3, 3] *= scale
            orbit_c2w[:, :3, 3] *= scale
            poses = torch.tensor(ring, dtype=torch.float32,
                                 device=self.device)
            self.poses.append(poses)
            self.orbit.append(torch.tensor(orbit_c2w, dtype=torch.float32,
                                           device=self.device))
            self.images.append(render(poses, self.wh, self.focal,
                                      radius * SPHERE_RADIUS_FRAC * scale))

    def source_stack(self, scene: int, views) -> Dict[str, torch.Tensor]:
        """Source arrays of `views` of `scene`: images in [-1, 1]."""
        idx = torch.as_tensor(list(views), device=self.device)
        imgs = self.images[scene].index_select(0, idx).float() / 255.0
        nv = len(views)
        return {"src_imgs": imgs * 2.0 - 1.0,
                "src_poses": self.poses[scene].index_select(0, idx),
                "src_focal": torch.full((nv,), self.focal,
                                        device=self.device),
                "src_c": self.c.to(self.device).expand(nv, 2).contiguous()}

    def dest_rays(self, scene: int, view_ids: np.ndarray, xs: np.ndarray,
                  ys: np.ndarray) -> Dict[str, torch.Tensor]:
        """Rays and target colours at (view, pixel) triples of `scene`."""
        v = torch.as_tensor(view_ids, device=self.device)
        x = torch.as_tensor(xs, device=self.device)
        y = torch.as_tensor(ys, device=self.device)
        o, d, vd = pixel_rays(self.poses[scene].index_select(0, v),
                              x.double(), y.double(), self.wh, self.focal)
        target = self.images[scene][v, y, x].float() / 255.0
        return {"rays_o": o, "rays_d": d, "viewdirs": vd, "target": target}

    def radii(self, n: int) -> torch.Tensor:
        """The base radii (n, 1) of n pixels' cones: the distance between
        neighbouring pixels' unnormalized directions, 1 / focal, times
        2 / sqrt(12)."""
        return torch.full((n, 1), 2.0 / (self.focal * np.sqrt(12.0)),
                          dtype=torch.float32, device=self.device)

    def orbit_rays(self, scene: int, view: int) -> Dict[str, torch.Tensor]:
        """One ray per pixel of orbit camera `view`, row-major."""
        w, h = self.wh
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=torch.float64, device=self.device),
            torch.arange(w, dtype=torch.float64, device=self.device),
            indexing="ij")
        c2w = self.orbit[scene][view]
        o, d, vd = pixel_rays(c2w.expand((h * w, 4, 4)), xs.reshape(-1),
                              ys.reshape(-1), self.wh, self.focal)
        return {"rays_o": o, "rays_d": d, "viewdirs": vd}


def _draw_scene(rng, pool: ScenePool, scene: int, n_src: int, n_dest: int,
                steps: int, n_rays: int):
    """(source stack, rays (steps, n_rays, ...)) of one scene: random
    source views, then each step's destination views and pixels."""
    n_views = pool.poses[scene].shape[0]
    src = rng.choice(n_views, n_src, replace=False)
    dest_pool = np.setdiff1d(np.arange(n_views), src)
    n_dest = min(n_dest, len(dest_pool))
    w, h = pool.wh
    vids, xs, ys = [], [], []
    for _ in range(steps):
        dest = rng.choice(dest_pool, n_dest, replace=False)
        vids.append(dest[rng.integers(0, n_dest, n_rays)])
        xs.append(rng.integers(0, w, n_rays))
        ys.append(rng.integers(0, h, n_rays))
    rays = pool.dest_rays(scene, np.concatenate(vids), np.concatenate(xs),
                          np.concatenate(ys))
    rays = {k: v.reshape((steps, n_rays) + v.shape[1:])
            for k, v in rays.items()}
    return pool.source_stack(scene, [int(v) for v in src]), rays


def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    pin = torch.cuda.is_available()
    out = {}
    for k, v in tensors.items():
        v = v.detach().to("cpu").contiguous()
        out[k] = v.pin_memory() if pin else v
    return out


def make_items(mix: Dict, seed: int, device, n_src: int, steps: int = 1,
               scenes_per_item: int = 1, rays_per_step: int = 500
               ) -> Dict:
    """The mix's items, drawn from `seed`: {"kind" (the item's role:
    "stage", "step" or "view"), "items": [host tensor dicts],
    "rays_per_item", "steps_per_item", "setup" (the view mixes' source
    stack, else None)}. `steps`, `scenes_per_item` and `rays_per_step` are
    the trainer's K, S and B (the program's preset); a "stage" item holds
    src (S, NV, ...) and rays (K, S, B/S, ...) when S > 1, else (NV, ...)
    and (K, B, ...); a "step" item one batch of the per-step trainer; a
    "rays" item B rays of scene 0 (`n_src` unused)."""
    kind = mix["kind"]
    if kind not in ROLE:
        raise ValueError(f"traffic kind {kind!r}: one of {sorted(ROLE)}")
    rng = np.random.default_rng([seed, 11])
    pool = ScenePool(seed, mix["scenes_in_pool"],
                     mix["train_views_per_scene"], mix["img_wh"],
                     mix["camera_radius"], device,
                     mix.get("orbit_views", 0),
                     mix.get("orbit_elevation_deg", 35.0))
    n_scenes = mix["scenes_in_pool"]
    w, h = pool.wh
    out = {"kind": ROLE[kind], "setup": None, "steps_per_item": 1}
    if kind in ("view", "image"):
        if kind == "view":
            out["setup"] = _host(pool.source_stack(0,
                                                   SRC_VIEWS_ORBIT[:n_src]))
        items = []
        for v in rng.permutation(mix["orbit_views"]):
            rays = pool.orbit_rays(0, int(v))
            if kind == "image":
                rays["radii"] = pool.radii(w * h)
            items.append(_host(rays))
        return dict(out, items=items, rays_per_item=w * h)
    items: List[Dict[str, torch.Tensor]] = []
    if kind == "rays":
        n_views = pool.poses[0].shape[0]
        for _ in range(mix["items_in_pool"]):
            rays = pool.dest_rays(0, rng.integers(0, n_views, rays_per_step),
                                  rng.integers(0, w, rays_per_step),
                                  rng.integers(0, h, rays_per_step))
            rays["radii"] = pool.radii(rays_per_step)
            items.append(_host(rays))
        return dict(out, items=items, rays_per_item=rays_per_step)
    for _ in range(mix["items_in_pool"]):
        if kind == "step":
            scene = int(rng.integers(n_scenes))
            src, rays = _draw_scene(rng, pool, scene, n_src,
                                    mix["dest_views_per_sample"], 1,
                                    rays_per_step)
            items.append(_host(dict(src, **{k: v[0]
                                            for k, v in rays.items()})))
            continue
        s = scenes_per_item
        if rays_per_step % s or s > n_scenes:
            raise ValueError(f"{rays_per_step} rays over {s} scenes of "
                             f"{n_scenes}")
        picks = rng.choice(n_scenes, s, replace=False)
        drawn = [_draw_scene(rng, pool, int(p), n_src,
                             mix["dest_views_per_sample"], steps,
                             rays_per_step // s) for p in picks]
        if s == 1:
            src, rays = drawn[0]
        else:
            src = {k: torch.stack([d[0][k] for d in drawn])
                   for k in SRC_KEYS}
            rays = {k: torch.stack([d[1][k] for d in drawn], 1)
                    for k in drawn[0][1]}
        items.append(_host(dict(src, **rays)))
    return dict(out, items=items, rays_per_item=steps * rays_per_step,
                steps_per_item=steps)


def to_device(item: Dict[str, torch.Tensor], device) -> Dict:
    """An item's tensors on `device` (an asynchronous copy from pinned
    memory on the card)."""
    return {k: v.to(device, non_blocking=True) for k, v in item.items()}

