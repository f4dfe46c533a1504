"""NERDS360_AE few-shot scenes (port of
neo360_tpu/data/nerds360_ae.py): the train, val and test splits, and the
nearest-view selection `get_nearest_pose_ids`.

- train: a random scene, `num_src_views` random source views of its 100
  train cameras and `ray_batch_size` rays drawn across up to 20 of the
  other views (`sample_train`); the scene-stage sampler draws S distinct
  scenes and K ray batches per scene with the same rng order
  (`sample_train_stage`). With `optimize` the source views are the fixed
  list [0, 38, 44] ([0, 38, 44, 94, 48] for 5 views) and the rays are
  drawn from those views (`optimize_source_stack` gives a scene's stack);
  with `finetune_lpips` a sample's rays are one `patch_size`^2 patch of
  one destination view (neo360_tpu/data/nerds360_ae.py:242-253,
  299-339: the same draws from the same numpy Generator calls, in the
  same order).
- val: a full image of a held-out train camera (index 100 + i) with the
  fixed source stack [0, 38, 44] (5 views: [0, 38, 44, 94, 48]).
- test: a full image of a scene's val/ directory (poses at the train
  split's scale) with the fixed source stack [0, 15, 38, 52, 70] (3 views:
  [0, 38, 44]).

With several nodes (`process_index` / `process_count`, default one node;
`cli.run_train` passes the rank's node and the node count) the train
split keeps the node's round-robin share of the scenes (neo360_tpu/data/
nerds360_ae.py:126-141); val and test keep every scene.

Source images are normalized to [-1, 1]; decoded images are cached per
loader. Outputs are numpy. PIL (and cv2, for the instance masks) are
imported only inside the image readers.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from neo360_tpu_torch.data import poses as pose_io

CAR_SEMANTIC_ID = 5
SRC_VIEWS_3 = [0, 38, 44]
SRC_VIEWS_5_OPTIMIZE = [0, 38, 44, 94, 48]
SRC_VIEWS_5_TEST = [0, 15, 38, 52, 70]
PATCH_SIZE = 30
RAY_KEYS = ("rays_o", "viewdirs", "rays_d", "target")


@dataclass
class SceneMeta:
    name: str
    c2w_train: np.ndarray          # (<=100, 4, 4) normalized
    c2w_val_tail: np.ndarray       # train-split cameras 100:
    c2w_test: np.ndarray           # val/ directory cameras (train scale)
    focal: float                   # scaled to img_wh
    c: np.ndarray                  # (2,) principal point at img_wh
    img_files_train: List[str]
    img_files_test: List[str]


def rays_at_pixels(c2w: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                   w: int, h: int, focal: float):
    """Rays through pixel corners (no +0.5) of one camera: rays_o,
    viewdirs, rays_d, each (N, 3) float32."""
    dirs = np.stack(
        [(xs - w / 2.0) / focal, -(ys - h / 2.0) / focal,
         -np.ones_like(xs, dtype=np.float64)], axis=-1)
    rays_d = dirs @ c2w[:3, :3].T
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return (rays_o.astype(np.float32), viewdirs.astype(np.float32),
            rays_d.astype(np.float32))


def default_src_views(num_src_views: int, test: bool = True) -> List[int]:
    """The fixed test (or val) source list for `num_src_views` views."""
    if num_src_views == 3:
        return SRC_VIEWS_3
    full = SRC_VIEWS_5_TEST if test else SRC_VIEWS_5_OPTIMIZE
    if num_src_views > len(full):
        raise ValueError(f"num_src_views {num_src_views} > "
                         f"{len(full)} known source views")
    return full[:num_src_views]


def source_stack(images: List[np.ndarray], c2ws: List[np.ndarray],
                 focal: float, c: np.ndarray) -> Dict[str, np.ndarray]:
    """Source-view arrays from images in [0, 1] and their poses."""
    nv = len(images)
    return {
        "src_imgs": (np.stack(images) * 2.0 - 1.0).astype(np.float32),
        "src_poses": np.stack(c2ws).astype(np.float32),
        "src_focal": np.full((nv,), focal, np.float32),
        "src_c": np.tile(c, (nv, 1)).astype(np.float32),
    }


def full_image_rays(c2w: np.ndarray, w: int, h: int,
                    focal: float) -> Dict[str, np.ndarray]:
    """One ray per pixel, row-major."""
    ys_g, xs_g = np.mgrid[0:h, 0:w]
    o, v, d = rays_at_pixels(c2w, xs_g.reshape(-1).astype(np.float64),
                             ys_g.reshape(-1).astype(np.float64), w, h, focal)
    return {"rays_o": o, "viewdirs": v, "rays_d": d}


class NeRDS360AE:
    """Few-shot multi-scene sampler over a root of NERDS360 scene dirs."""

    def __init__(self, root_dir: str, split: str = "test",
                 img_wh: Tuple[int, int] = (320, 240),
                 num_src_views: int = 3, ray_batch_size: int = 500,
                 dest_views_per_sample: int = 20, optimize: bool = False,
                 finetune_lpips: bool = False,
                 patch_size: int = PATCH_SIZE,
                 process_index: int = 0, process_count: int = 1):
        if split not in ("train", "val", "test"):
            raise ValueError(f"split {split!r}: expected train, val or test")
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.num_src_views = num_src_views
        self.ray_batch_size = ray_batch_size
        self.dest_views_per_sample = dest_views_per_sample
        self.optimize = optimize
        self.finetune_lpips = finetune_lpips
        self.patch_size = patch_size
        self.scene_ids = self._scene_ids()
        if not self.scene_ids:
            raise ValueError(f"no scene directories under {root_dir!r}")
        self.process_index, self.process_count = process_index, process_count
        if split == "train" and process_count > 1:
            shard = self.scene_ids[process_index::process_count]
            if not shard:
                raise ValueError(
                    f"host {process_index}/{process_count} has no scenes "
                    f"({len(self.scene_ids)} total) — need >= 1 per host")
            self.scene_ids = shard
        self._meta_cache: Dict[str, SceneMeta] = {}
        self._img_cache: Dict[tuple, np.ndarray] = {}

    def _scene_ids(self) -> List[str]:
        return sorted(f.name for f in os.scandir(self.root_dir)
                      if f.is_dir())

    def scene_meta(self, name: str) -> SceneMeta:
        if name in self._meta_cache:
            return self._meta_cache[name]
        scene_dir = os.path.join(self.root_dir, name)
        img_files_train = pose_io.sorted_image_files(scene_dir, "train")
        cams = pose_io.read_poses(os.path.join(scene_dir, "train", "pose"),
                                  img_files_train)
        w, h = self.img_wh
        img_files_test: List[str] = []
        c2w_test = np.zeros((0, 4, 4), np.float32)
        val_dir = os.path.join(scene_dir, "val")
        if os.path.isdir(os.path.join(val_dir, "rgb")):
            img_files_test = pose_io.sorted_image_files(scene_dir, "val")
            c2w_test = pose_io.read_poses_with_scale(
                os.path.join(val_dir, "pose"), img_files_test,
                cams.pose_scale_factor)
        meta = SceneMeta(
            name=name, c2w_train=cams.c2w_train, c2w_val_tail=cams.c2w_val,
            c2w_test=c2w_test,
            focal=float(cams.focal * w / cams.img_wh[0]),
            c=np.array([w / 2.0, h / 2.0], dtype=np.float32),
            img_files_train=cams.img_files_train,
            img_files_test=img_files_test)
        self._meta_cache[name] = meta
        return meta

    def _load_rgb(self, name: str, split_dir: str, img_file: str):
        key = (name, split_dir, img_file)
        if key not in self._img_cache:
            from PIL import Image
            path = os.path.join(self.root_dir, name, split_dir, "rgb",
                                img_file)
            img = Image.open(path).resize(self.img_wh, Image.LANCZOS)
            self._img_cache[key] = (np.asarray(img, np.float32)
                                    / 255.0)[..., :3]
        return self._img_cache[key]

    def _load_car_mask(self, name: str, split_dir: str, img_file: str):
        path = os.path.join(self.root_dir, name, split_dir,
                            "semantic_segmentation_2d", img_file)
        if not os.path.exists(path):
            return None
        import cv2
        from PIL import Image
        seg = (np.array(Image.open(path)) == CAR_SEMANTIC_ID).astype(np.uint8)
        seg = cv2.resize(seg, self.img_wh, interpolation=cv2.INTER_NEAREST)
        return seg.astype(np.float32)

    def _source_stack(self, meta: SceneMeta, view_ids) -> Dict[str,
                                                                np.ndarray]:
        return source_stack(
            [self._load_rgb(meta.name, "train", meta.img_files_train[v])
             for v in view_ids], [meta.c2w_train[v] for v in view_ids],
            meta.focal, meta.c)

    def _dest_rays(self, meta: SceneMeta, view_ids: np.ndarray,
                   xs: np.ndarray, ys: np.ndarray, c2w_table: np.ndarray,
                   img_files: List[str], split_dir: str
                   ) -> Dict[str, np.ndarray]:
        """Rays and targets for (view, pixel) triples, vectorized per
        unique view: rays_o, viewdirs, rays_d, target, each (N, 3) float32.
        (The JAX loader also returns nocs, mask and radii, which no ported
        path reads.)"""
        n = xs.shape[0]
        out = {k: np.empty((n, 3), np.float32) for k in RAY_KEYS}
        w, h = self.img_wh
        for vid in np.unique(view_ids):
            sel = view_ids == vid
            o, v, d = rays_at_pixels(
                c2w_table[vid], xs[sel].astype(np.float64),
                ys[sel].astype(np.float64), w, h, meta.focal)
            out["rays_o"][sel], out["viewdirs"][sel], out["rays_d"][sel] = \
                o, v, d
            rgb = self._load_rgb(meta.name, split_dir, img_files[vid])
            out["target"][sel] = rgb[ys[sel], xs[sel]]
        return out

    def _optimize_src(self) -> List[int]:
        """The optimize mode's fixed source views."""
        if self.num_src_views == 3:
            return SRC_VIEWS_3
        if self.num_src_views == 5:
            return SRC_VIEWS_5_OPTIMIZE
        return SRC_VIEWS_3[:1]

    def _draw(self, rng: np.random.Generator, meta: SceneMeta):
        """(source views, destination pool) of one training sample: in
        optimize mode the fixed list for both, else random source views and
        the other train views."""
        if self.optimize:
            src = self._optimize_src()
            return src, np.asarray(src)
        n_train = len(meta.c2w_train)
        src = rng.choice(n_train, self.num_src_views, replace=False)
        return src, np.setdiff1d(np.arange(n_train), src)

    def optimize_source_stack(self, scene_idx: int) -> Dict[str, np.ndarray]:
        """Scene `scene_idx`'s optimize-mode source stack, the one every
        optimize-mode sample of it carries (for caching its frozen pixel
        latents, cli._optimize_latents)."""
        meta = self.scene_meta(self.scene_ids[scene_idx])
        return self._source_stack(meta, self._optimize_src())

    def sample_train(self, rng: np.random.Generator) -> Dict[str,
                                                              np.ndarray]:
        """One training sample: a random scene's source stack and
        `ray_batch_size` rays across up to 20 of its destination views (with
        `finetune_lpips`: one `patch_size`^2 patch, row-major, of one
        destination view), with `scene_idx`."""
        sid = int(rng.integers(len(self.scene_ids)))
        meta = self.scene_meta(self.scene_ids[sid])
        w, h = self.img_wh
        src, dest_pool = self._draw(rng, meta)
        sample = self._source_stack(meta, list(src))
        if self.finetune_lpips:
            p = self.patch_size
            vid = int(rng.choice(dest_pool))
            x0 = int(rng.integers(0, w - p + 1))
            y0 = int(rng.integers(0, h - p + 1))
            ys_g, xs_g = np.mgrid[y0:y0 + p, x0:x0 + p]
            xs, ys = xs_g.reshape(-1), ys_g.reshape(-1)
            view_ids = np.full_like(xs, vid)
        else:
            n_dest = min(self.dest_views_per_sample, len(dest_pool))
            dest = rng.choice(dest_pool, n_dest, replace=False)
            view_ids = dest[rng.integers(0, n_dest, self.ray_batch_size)]
            xs = rng.integers(0, w, self.ray_batch_size)
            ys = rng.integers(0, h, self.ray_batch_size)
        sample.update(self._dest_rays(meta, view_ids, xs, ys, meta.c2w_train,
                                      meta.img_files_train, "train"))
        sample["scene_idx"] = np.asarray(sid, np.int32)
        return sample

    def _stage_for_scene(self, rng, meta: SceneMeta, k_steps: int,
                         n_rays: int):
        """(source stack, k_steps stacked ray dicts) of one scene, drawn in
        the rng order of k_steps `sample_train` draws, rays generated in one
        vectorized pass."""
        w, h = self.img_wh
        src, dest_pool = self._draw(rng, meta)
        sample = self._source_stack(meta, list(src))
        n_dest = min(self.dest_views_per_sample, len(dest_pool))
        vids, xss, yss = [], [], []
        for _ in range(k_steps):
            dest = rng.choice(dest_pool, n_dest, replace=False)
            vids.append(dest[rng.integers(0, n_dest, n_rays)])
            xss.append(rng.integers(0, w, n_rays))
            yss.append(rng.integers(0, h, n_rays))
        flat = self._dest_rays(meta, np.concatenate(vids),
                               np.concatenate(xss), np.concatenate(yss),
                               meta.c2w_train, meta.img_files_train, "train")
        stacked = {k: v.reshape((k_steps, n_rays) + v.shape[1:])
                   for k, v in flat.items()}
        return sample, stacked

    def sample_train_stage(self, rng: np.random.Generator, k_steps: int,
                           n_scenes: int = 1) -> Dict[str, np.ndarray]:
        """A scene stage for the encode-once trainer: `n_scenes` scenes'
        source stacks shared by `k_steps` steps, and each step's rays.

        n_scenes == 1: source arrays (NV, ...), rays (k_steps, B, ...).
        n_scenes > 1 (scene-mixed): distinct scenes; source arrays
        (S, NV, ...), rays (k_steps, S, B // S, ...)."""
        n_avail = len(self.scene_ids)
        if n_scenes == 1:
            meta = self.scene_meta(self.scene_ids[rng.integers(n_avail)])
            sample, stacked = self._stage_for_scene(
                rng, meta, k_steps, self.ray_batch_size)
            sample.update(stacked)
            return sample
        if n_scenes > n_avail:
            raise ValueError(f"n_scenes {n_scenes} > {n_avail} scenes")
        if self.ray_batch_size % n_scenes:
            raise ValueError(f"ray_batch_size {self.ray_batch_size} must "
                             f"divide by n_scenes {n_scenes}")
        per = self.ray_batch_size // n_scenes
        picks = rng.choice(n_avail, n_scenes, replace=False)
        srcs, rays = [], []
        for idx in picks:
            s, r = self._stage_for_scene(
                rng, self.scene_meta(self.scene_ids[idx]), k_steps, per)
            srcs.append(s)
            rays.append(r)
        out = {k: np.stack([s[k] for s in srcs]) for k in srcs[0]}
        out.update({k: np.stack([r[k] for r in rays], axis=1)
                    for k in rays[0]})
        return out

    def sample_train_scenes(self, rng: np.random.Generator, n_scenes: int
                            ) -> Dict[str, np.ndarray]:
        """One training step over `n_scenes` distinct scenes (the
        pixelnerf batch): source arrays (S, NV, ...) and rays (S, B // S,
        ...), drawn as a one-step scene-mixed stage
        (`sample_train_stage`)."""
        if n_scenes < 2:
            raise ValueError(f"{n_scenes} scenes: use sample_train")
        stage = self.sample_train_stage(rng, 1, n_scenes)
        return {k: v if k.startswith("src_") else v[0]
                for k, v in stage.items()}

    def sample_val(self, scene_idx: int, dest_offset: int = 0,
                   src_views: Optional[List[int]] = None):
        """Full-image sample of the held-out train camera 100 + i."""
        meta = self.scene_meta(self.scene_ids[scene_idx])
        if len(meta.c2w_val_tail) == 0:
            raise ValueError(f"scene {meta.name} has no held-out tail views")
        dest = dest_offset % len(meta.c2w_val_tail)
        src = (src_views if src_views is not None
               else default_src_views(self.num_src_views, test=False))
        sample = self._source_stack(meta, src)
        w, h = self.img_wh
        ys_g, xs_g = np.mgrid[0:h, 0:w]
        xs, ys = xs_g.reshape(-1), ys_g.reshape(-1)
        c2w_table = np.concatenate([meta.c2w_train, meta.c2w_val_tail])
        view_ids = np.full_like(xs, len(meta.c2w_train) + dest)
        sample.update(self._dest_rays(meta, view_ids, xs, ys, c2w_table,
                                      meta.img_files_train, "train"))
        sample["img_wh"] = np.asarray([w, h])
        return sample

    def sample_pose(self, scene_idx: int, c2w: np.ndarray,
                    src_views: Optional[List[int]] = None):
        """Full-image sample of any destination pose, without a target:
        the test split's source stack (so a scene's cached encode serves
        every pose) and one ray per pixel (the vis_only flythrough,
        neo360_tpu/data/nerds360_ae.py:454-473; radii are the JAX
        loader's constant pixel radii)."""
        meta = self.scene_meta(self.scene_ids[scene_idx])
        src = src_views or default_src_views(self.num_src_views)
        sample = self._source_stack(meta, src)
        w, h = self.img_wh
        sample.update(full_image_rays(np.asarray(c2w, np.float64), w, h,
                                      meta.focal))
        sample["radii"] = np.full((w * h, 1), 2.0 / (meta.focal *
                                                     np.sqrt(12.0)),
                                  np.float32)
        sample["img_wh"] = np.asarray([w, h])
        return sample

    def sample_test(self, scene_idx: int, dest_idx: int,
                    src_views: Optional[List[int]] = None):
        """Full-image sample of the scene's val/ view `dest_idx`: source
        stack, rays, target (H*W, 3) and, where the scene has segmentation,
        instance_mask (H*W, 1)."""
        meta = self.scene_meta(self.scene_ids[scene_idx])
        src = src_views or default_src_views(self.num_src_views)
        sample = self._source_stack(meta, src)
        w, h = self.img_wh
        sample.update(full_image_rays(meta.c2w_test[dest_idx], w, h,
                                      meta.focal))
        img_file = meta.img_files_test[dest_idx]
        sample["target"] = self._load_rgb(meta.name, "val",
                                          img_file).reshape(-1, 3)
        mask = self._load_car_mask(meta.name, "val", img_file)
        if mask is not None:
            sample["instance_mask"] = mask.reshape(-1, 1)
        sample["img_wh"] = np.asarray([w, h])
        return sample

    def num_test_views(self, scene_idx: int) -> int:
        return len(self.scene_meta(self.scene_ids[scene_idx]).c2w_test)


def get_nearest_pose_ids(tar_pose: np.ndarray, ref_poses: np.ndarray,
                         num_select: int = 4, tar_id: int = -1,
                         angular_dist_method: str = "vector",
                         scene_center=(0, 0, 0)) -> np.ndarray:
    """The `num_select` reference views nearest `tar_pose` (at most all but
    one), nearest first, by rotation angle ("matrix"), angle between the
    look-from vectors about `scene_center` ("vector") or camera distance
    ("dist"); `tar_id` >= 0 excludes that view (the reference's
    nerds360_ae.py:80-124)."""
    tiny = 1e-6
    num_cams = len(ref_poses)
    num_select = min(num_select, num_cams - 1)
    if angular_dist_method == "matrix":
        r1 = np.broadcast_to(tar_pose[:3, :3], (num_cams, 3, 3))
        r2 = ref_poses[:, :3, :3]
        tr = np.trace(np.matmul(r2.transpose(0, 2, 1), r1),
                      axis1=1, axis2=2)
        dists = np.arccos(np.clip((tr - 1) / 2.0, -1 + tiny, 1 - tiny))
    elif angular_dist_method == "vector":
        tv = tar_pose[:3, 3][None] - np.asarray(scene_center)[None]
        rv = ref_poses[:, :3, 3] - np.asarray(scene_center)[None]
        tu = tv / (np.linalg.norm(tv, axis=1, keepdims=True) + tiny)
        ru = rv / (np.linalg.norm(rv, axis=1, keepdims=True) + tiny)
        dists = np.arccos(np.clip(np.sum(tu * ru, axis=-1), -1.0, 1.0))
    elif angular_dist_method == "dist":
        dists = np.linalg.norm(tar_pose[:3, 3][None] - ref_poses[:, :3, 3],
                               axis=1)
    else:
        raise ValueError(angular_dist_method)
    if tar_id >= 0:
        dists[tar_id] = 1e3
    return np.argsort(dists)[:num_select]
