"""Validation image grids and 3D scene inspection (port of
neo360_tpu/utils/visualize.py).

Grids: GT, prediction, depth, normals, fg / bg, opacity and NOCS tiles
side by side, built with numpy (cv2 colours the depth tile).

3D: depth maps back-projected to world points, camera frustum wireframes,
look-at poses, the pose sphere's wireframe and sampled ray segments, as
numpy arrays. The interactive viewers need open3d and raise without it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from neo360_tpu_torch.utils.io import visualize_depth


def _to_hw3(x, h: int, w: int) -> np.ndarray:
    """(H,W,3), flat (H*W,3), (H,W) or flat (H*W,) -> (H, W, 3)."""
    x = np.asarray(x)
    if x.shape == (h, w):
        x = np.repeat(x[..., None], 3, axis=-1)
    elif x.ndim == 1:
        x = np.repeat(x.reshape(h, w, 1), 3, axis=-1)
    return x.reshape(h, w, 3)


def tile_images(images: Sequence[np.ndarray], pad: int = 2,
                pad_value: float = 1.0) -> np.ndarray:
    """Horizontal strip of equally sized (H, W, 3) images."""
    h = images[0].shape[0]
    spacer = np.full((h, pad, 3), pad_value, dtype=np.float32)
    row = []
    for i, img in enumerate(images):
        if i:
            row.append(spacer)
        row.append(np.asarray(img, np.float32))
    return np.concatenate(row, axis=1)


def visualize_val_fg_bg_opacity(img_wh, target, rgb, fg_rgb, bg_rgb,
                                fg_acc, bg_acc) -> np.ndarray:
    w, h = img_wh
    clip = lambda x: _to_hw3(np.clip(x, 0, 1), h, w)
    return tile_images([_to_hw3(target, h, w), clip(rgb), clip(fg_rgb),
                        clip(bg_rgb), clip(fg_acc), clip(bg_acc)])


def visualize_val_rgb_depth(img_wh, target, rgb, depth=None) -> np.ndarray:
    """GT | prediction [| depth]."""
    w, h = img_wh
    tiles = [_to_hw3(target, h, w), _to_hw3(np.clip(rgb, 0, 1), h, w)]
    if depth is not None:
        tiles.append(visualize_depth(np.asarray(depth).reshape(h, w)))
    return tile_images(tiles)


def visualize_val_fg_bg(img_wh, target, rgb, fg_rgb, bg_rgb, depth=None,
                        acc=None) -> np.ndarray:
    """GT | comp | fg | bg [| depth] [| opacity]."""
    w, h = img_wh
    clip = lambda x: _to_hw3(np.clip(x, 0, 1), h, w)
    tiles = [_to_hw3(target, h, w), clip(rgb), clip(fg_rgb), clip(bg_rgb)]
    if depth is not None:
        tiles.append(visualize_depth(np.asarray(depth).reshape(h, w)))
    if acc is not None:
        tiles.append(clip(acc))
    return tile_images(tiles)


def visualize_val_rgb_opa_depth(img_wh, target, rgb, acc,
                                depth) -> np.ndarray:
    """GT | prediction | opacity | depth."""
    w, h = img_wh
    return tile_images([
        _to_hw3(target, h, w), _to_hw3(np.clip(rgb, 0, 1), h, w),
        _to_hw3(np.clip(acc, 0, 1), h, w),
        visualize_depth(np.asarray(depth).reshape(h, w))])


def visualize_val_rgb(img_wh, target, rgb) -> np.ndarray:
    """GT | prediction."""
    w, h = img_wh
    return tile_images([_to_hw3(target, h, w),
                        _to_hw3(np.clip(rgb, 0, 1), h, w)])


def visualize_val_opacity(img_wh, rgb, acc) -> np.ndarray:
    """prediction | opacity."""
    w, h = img_wh
    return tile_images([_to_hw3(np.clip(rgb, 0, 1), h, w),
                        _to_hw3(np.clip(acc, 0, 1), h, w)])


def visualize_val_rgb_opacity_nocs(img_wh, target, rgb, acc, nocs_gt,
                                   nocs_pred) -> np.ndarray:
    """GT | prediction | opacity | NOCS GT | NOCS prediction."""
    w, h = img_wh
    clip = lambda x: _to_hw3(np.clip(x, 0, 1), h, w)
    return tile_images([_to_hw3(target, h, w), clip(rgb), clip(acc),
                        clip(nocs_gt), clip(nocs_pred)])


def depth_normals(depth: np.ndarray) -> np.ndarray:
    """Screen-space normals of a depth map, (H, W) -> (H, W, 3) in [0, 1]."""
    d = np.asarray(depth, np.float32)
    gy, gx = np.gradient(d)
    n = np.stack([-gx, -gy, np.ones_like(d)], axis=-1)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    return 0.5 * (n + 1.0)


def visualize_val_rgb_opa_depth_normals(img_wh, target, rgb, acc,
                                        depth) -> np.ndarray:
    """GT | prediction | opacity | depth | normals."""
    w, h = img_wh
    d = np.asarray(depth).reshape(h, w)
    return tile_images([
        _to_hw3(target, h, w), _to_hw3(np.clip(rgb, 0, 1), h, w),
        _to_hw3(np.clip(acc, 0, 1), h, w), visualize_depth(d),
        depth_normals(d)])


def build_val_grid(img_wh, target, outputs: Dict) -> np.ndarray:
    """The richest grid that the rendered `outputs` (host arrays) support,
    as the JAX trainer picks it: fg / bg with both opacities (NeO-360),
    fg / bg, rgb + opacity + depth (vanilla), else rgb [+ depth]
    (PixelNeRF)."""
    has = lambda *ks: all(outputs.get(k) is not None for k in ks)
    if has("fg_rgb", "bg_rgb", "fg_acc", "bg_acc"):
        return visualize_val_fg_bg_opacity(
            img_wh, target, outputs["rgb"], outputs["fg_rgb"],
            outputs["bg_rgb"], outputs["fg_acc"], outputs["bg_acc"])
    if has("fg_rgb", "bg_rgb"):
        return visualize_val_fg_bg(img_wh, target, outputs["rgb"],
                                   outputs["fg_rgb"], outputs["bg_rgb"],
                                   outputs.get("depth"), outputs.get("acc"))
    if has("acc", "depth"):
        return visualize_val_rgb_opa_depth(img_wh, target, outputs["rgb"],
                                           outputs["acc"], outputs["depth"])
    return visualize_val_rgb_depth(img_wh, target, outputs["rgb"],
                                   outputs.get("depth"))


# --- 3D geometry (the numpy core of the Open3D inspectors) ---------------

def depth_to_points(depth: np.ndarray, c2w: np.ndarray, focal: float,
                    max_depth: Optional[float] = None) -> np.ndarray:
    """An (H, W) depth map back-projected to world points (N, 3) along the
    renderer's rays (-z forward, unnormalized, no +0.5 centring), those
    deeper than `max_depth` dropped."""
    h, w = depth.shape
    i, j = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    dirs = np.stack([(i - w / 2) / focal, -(j - h / 2) / focal,
                     -np.ones_like(i)], -1)
    rays_d = dirs @ np.asarray(c2w)[:3, :3].T
    pts = np.asarray(c2w)[:3, 3] + depth[..., None] * rays_d
    pts = pts.reshape(-1, 3)
    if max_depth is not None:
        pts = pts[depth.reshape(-1) <= max_depth]
    return pts


def camera_frustum_lines(c2w: np.ndarray, focal: float, img_wh,
                         scale: float = 0.1):
    """(points (5, 3), line index pairs (8, 2)) of a camera's frustum
    wireframe: the apex, then the image corners at depth `scale`."""
    w, h = img_wh
    corners_cam = np.array([
        [0, 0, 0],
        [(0 - w / 2) / focal, (h / 2) / focal, -1.0],
        [(w - w / 2) / focal, (h / 2) / focal, -1.0],
        [(w - w / 2) / focal, (0 - h / 2) / focal, -1.0],
        [(0 - w / 2) / focal, (0 - h / 2) / focal, -1.0],
    ]) * scale
    pts = corners_cam @ np.asarray(c2w)[:3, :3].T + np.asarray(c2w)[:3, 3]
    lines = np.array([[0, 1], [0, 2], [0, 3], [0, 4],
                      [1, 2], [2, 3], [3, 4], [4, 1]])
    return pts, lines


def look_at_pose(cam_location: np.ndarray, point: np.ndarray) -> np.ndarray:
    """4x4 c2w at `cam_location` looking toward `point` (+z forward)."""
    cam_location = np.asarray(cam_location, np.float64)
    forward = np.asarray(point, np.float64) - cam_location
    forward = forward / (np.linalg.norm(forward) + 1e-9)
    right = np.cross(np.array([0.0, -1.0, 0.0]), forward)
    right = right / (np.linalg.norm(right) + 1e-9)
    up = np.cross(forward, right)
    up = up / (np.linalg.norm(up) + 1e-9)
    mat = np.eye(4)
    mat[:3, 0], mat[:3, 1], mat[:3, 2], mat[:3, 3] = (right, up, forward,
                                                      cam_location)
    return mat


def merge_frustums(frustums: Sequence) -> tuple:
    """[(points (5,3), lines (8,2)), ...] -> one wireframe (N*5, 3),
    (N*8, 2)."""
    pts, lines = [], []
    for i, (p, l) in enumerate(frustums):
        pts.append(np.asarray(p))
        lines.append(np.asarray(l) + i * 5)
    return np.concatenate(pts, axis=0), np.concatenate(lines, axis=0)


def sphere_wireframe(radius: float = 1.0, n_lat: int = 8,
                     n_lon: int = 12, n_seg: int = 24) -> np.ndarray:
    """(N, 2, 3) segments of a sphere's latitude and longitude circles."""
    segs = []
    for k in range(1, n_lat):
        phi = np.pi * k / n_lat
        t = np.linspace(0, 2 * np.pi, n_seg + 1)
        ring = np.stack([np.sin(phi) * np.cos(t), np.sin(phi) * np.sin(t),
                         np.full_like(t, np.cos(phi))], axis=-1) * radius
        segs.append(np.stack([ring[:-1], ring[1:]], axis=1))
    for k in range(n_lon):
        lam = 2 * np.pi * k / n_lon
        t = np.linspace(0, np.pi, n_seg + 1)
        arc = np.stack([np.sin(t) * np.cos(lam), np.sin(t) * np.sin(lam),
                        np.cos(t)], axis=-1) * radius
        segs.append(np.stack([arc[:-1], arc[1:]], axis=1))
    return np.concatenate(segs, axis=0)


def ray_segments(c2w: np.ndarray, focal: float, img_wh,
                 n_rays: int = 64, near: float = 0.02, far: float = 2.0,
                 seed: int = 0) -> np.ndarray:
    """(n_rays, 2, 3) world segments [near, far] of the rays through
    random pixels of one camera (numpy Generator `seed`), on the
    renderer's -z convention."""
    w, h = img_wh
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, w, size=n_rays)
    ys = rng.uniform(0, h, size=n_rays)
    dirs = np.stack([(xs - w / 2) / focal, -(ys - h / 2) / focal,
                     -np.ones_like(xs)], axis=-1)
    c2w = np.asarray(c2w)
    rays_d = dirs @ c2w[:3, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return np.stack([rays_o + near * rays_d, rays_o + far * rays_d], axis=1)


def pose_sphere_geometry(c2ws: Sequence[np.ndarray], focal: float, img_wh,
                         n_ray_views: int = 1, rays_per_view: int = 64,
                         frustum_scale: float = 0.1) -> Dict:
    """The pose viewer's geometry: every camera's frustum wireframe, ray
    segments of the first `n_ray_views` cameras and the unit sphere."""
    frustums = [camera_frustum_lines(c2w, focal, img_wh, frustum_scale)
                for c2w in c2ws]
    points, lines = merge_frustums(frustums)
    rays = [ray_segments(c2w, focal, img_wh, rays_per_view, seed=i)
            for i, c2w in enumerate(c2ws[:n_ray_views])]
    return {
        "frustum_points": points,
        "frustum_lines": lines,
        "ray_segments": (np.concatenate(rays, axis=0) if rays
                         else np.zeros((0, 2, 3))),
        "sphere_segments": sphere_wireframe(),
    }


def _open3d(hint: str):
    try:
        import open3d
    except ImportError as e:
        raise ImportError(f"open3d is not installed; use {hint} for "
                          f"headless checks") from e
    return open3d


def _line_set(o3d, points, lines):
    return o3d.geometry.LineSet(o3d.utility.Vector3dVector(points),
                                o3d.utility.Vector2iVector(lines))


def show_poses_open3d(c2ws, focal, img_wh, **kw):  # pragma: no cover
    """Interactive pose-sphere viewer of `pose_sphere_geometry` (needs
    open3d)."""
    o3d = _open3d("pose_sphere_geometry")
    geo = pose_sphere_geometry(c2ws, focal, img_wh, **kw)
    geoms = [_line_set(o3d, geo["frustum_points"], geo["frustum_lines"])]
    for name in ("ray_segments", "sphere_segments"):
        pts = geo[name].reshape(-1, 3)
        geoms.append(_line_set(o3d, pts, np.arange(len(pts)).reshape(-1, 2)))
    o3d.visualization.draw_geometries(geoms)


def show_scene_open3d(pointclouds: Sequence[np.ndarray],
                      cameras: Sequence[Dict] = (),
                      unit_sphere: bool = True):  # pragma: no cover
    """Interactive viewer of point clouds and cameras (dicts with c2w,
    focal, img_wh; needs open3d)."""
    o3d = _open3d("depth_to_points / camera_frustum_lines")
    geoms = [o3d.geometry.PointCloud(
        o3d.utility.Vector3dVector(np.asarray(pts))) for pts in pointclouds]
    geoms += [_line_set(o3d, *camera_frustum_lines(
        cam["c2w"], cam["focal"], cam["img_wh"])) for cam in cameras]
    if unit_sphere:
        sphere = o3d.geometry.TriangleMesh.create_sphere(1.0)
        geoms.append(o3d.geometry.LineSet.create_from_triangle_mesh(sphere))
    o3d.visualization.draw_geometries(geoms)
