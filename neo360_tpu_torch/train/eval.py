"""Evaluation: render every test view, PSNR / SSIM (and, with pretrained
LPIPS weights, LPIPS) on the device, stream artifacts to disk; and the
360-degree spiral of the vis_only flythrough (port of
neo360_tpu/train/eval.py).

`evaluate` yields one `ViewResult` per view and holds nothing else, so
memory stays constant in the number of views. `evaluate_images` keeps
every view in an `EvalResult` and `save_eval_artifacts` writes one, the
JAX package's in-memory pair. `evaluate_and_save` writes
each view's JPEG and raw depth on a writer thread while the next view
renders, then the depth colormaps of every view with depth (normalized
by the largest depth of the set) and results.json; with `video=True`
(vis_only) also the views' video. PIL and cv2 are imported only by the
writers.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from neo360_tpu_torch.train import metrics as M
from neo360_tpu_torch.utils import io


@dataclass
class ViewResult:
    rgb: np.ndarray                 # (H, W, 3) float32
    depth: Optional[np.ndarray]     # (H, W) float32
    psnr: float
    ssim: float
    psnr_obj: Optional[float]
    lpips: Optional[float] = None


def object_psnr(rgb: np.ndarray, target: np.ndarray,
                mask: np.ndarray) -> Optional[float]:
    """PSNR inside the instance mask's bounding box (None without one)."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return None
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    mse = float(np.mean((rgb[y0:y1, x0:x1] - target[y0:y1, x0:x1]) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))


def evaluate(render_fn: Callable[[Dict], Dict[str, torch.Tensor]],
             samples: Iterable[Dict], img_wh,
             lpips_model=None) -> Iterator[ViewResult]:
    """render_fn(sample) -> {"rgb": (N, 3)[, "depth": (N,)]} tensors; each
    sample carries "target" (N, 3) and optionally "instance_mask". A
    pretrained `lpips_model` (nn.lpips.LPIPSModel, on the render's device)
    adds each view's LPIPS."""
    w, h = img_wh
    for sample in samples:
        out = render_fn(sample)
        pred = out["rgb"].float().reshape(h, w, 3)
        target = np.asarray(sample["target"], np.float32).reshape(h, w, 3)
        tgt = torch.as_tensor(target, device=pred.device)
        p, s = M.psnr(pred, tgt), M.ssim(pred, tgt)
        lp = None
        if lpips_model is not None and lpips_model.pretrained:
            with torch.no_grad():
                lp = float(lpips_model(pred[None], tgt[None])[0])
        rgb = pred.cpu().numpy()
        depth = None
        if "depth" in out:
            depth = out["depth"].float().reshape(h, w).cpu().numpy()
        op = None
        if "instance_mask" in sample:
            mask = np.asarray(sample["instance_mask"]).reshape(h, w) > 0
            op = object_psnr(rgb, target, mask)
        yield ViewResult(rgb, depth, float(p), float(s), op, lp)


@dataclass
class EvalResult:
    """Every view's metrics and images, in view order."""
    psnr: List[float] = field(default_factory=list)
    ssim: List[float] = field(default_factory=list)
    lpips: List[float] = field(default_factory=list)
    psnr_obj: List[float] = field(default_factory=list)
    rgbs: List[np.ndarray] = field(default_factory=list)
    depths: List[np.ndarray] = field(default_factory=list)
    targets: List[np.ndarray] = field(default_factory=list)

    def summary(self) -> Dict[str, float]:
        """The mean of each metric that has values."""
        return {name: float(np.mean(getattr(self, name)))
                for name in ("psnr", "ssim", "lpips", "psnr_obj")
                if getattr(self, name)}


def evaluate_images(render_fn: Callable[[Dict], Dict[str, torch.Tensor]],
                    samples: Iterable[Dict], img_wh,
                    lpips_model=None) -> EvalResult:
    """`evaluate` over every sample, collected into one `EvalResult` (the
    rendered rgb and depth, each sample's target, the metrics; views
    without an instance mask add no object PSNR)."""
    w, h = img_wh
    result = EvalResult()
    samples = list(samples)
    for sample, view in zip(samples, evaluate(render_fn, samples, img_wh,
                                              lpips_model)):
        result.rgbs.append(view.rgb)
        result.targets.append(
            np.asarray(sample["target"], np.float32).reshape(h, w, 3))
        if view.depth is not None:
            result.depths.append(view.depth)
        result.psnr.append(view.psnr)
        result.ssim.append(view.ssim)
        if view.lpips is not None:
            result.lpips.append(view.lpips)
        if view.psnr_obj is not None:
            result.psnr_obj.append(view.psnr_obj)
    return result


def save_eval_artifacts(result: EvalResult, out_dir: str,
                        results_json: Optional[str] = None,
                        video: bool = False) -> Dict[str, float]:
    """Write `result` under `out_dir`: image{i}.jpg, and with depths
    depth_img{i}.jpg (normalized by the largest depth of the set) and
    depth_raw{i}.npz; with `video` and more than one view the views as a
    video; each metric's mean in `results_json`. Returns the means."""
    io.store_image(out_dir, result.rgbs, "image")
    if result.depths:
        io.store_depth_img(out_dir, result.depths, "depth_img")
        io.store_depth_raw(out_dir, result.depths, "depth_raw")
    if video and len(result.rgbs) > 1:
        io.store_video(out_dir, result.rgbs)
    summary = result.summary()
    if results_json is not None:
        io.write_stats(results_json, **{k: {"mean": v}
                                        for k, v in summary.items()})
    return summary


def _write(kind: str, path: str, arr: np.ndarray) -> None:
    if kind == "jpg":
        from PIL import Image
        Image.fromarray(arr).save(path)
    else:
        np.savez_compressed(path, depth=arr)


def evaluate_and_save(render_fn, samples, img_wh, out_dir: str,
                      results_json: Optional[str] = None,
                      extra: Optional[Dict[str, str]] = None,
                      lpips_model=None, video: bool = False,
                      primary: bool = True) -> Dict[str, float]:
    """`evaluate` + image{i}.jpg / depth_raw{i}.npz / depth_img{i}.jpg
    (JET colormaps that share the largest depth of the set) under
    `out_dir`; with `video` also the views as video.mp4 (or .gif); each
    metric's mean and per-view values in `results_json` (without a
    pretrained `lpips_model`, "lpips_status" says LPIPS was skipped).
    Returns the means {psnr, ssim[, psnr_obj][, lpips]}. With `primary`
    False (a data-parallel rank other than 0) it renders and measures
    every view, as the collective renderer needs, and writes nothing."""
    if primary:
        os.makedirs(out_dir, exist_ok=True)
    vals: Dict[str, List[float]] = {"psnr": [], "ssim": [], "psnr_obj": [],
                                    "lpips": []}
    frames: List[np.ndarray] = []
    depth_files: List[str] = []
    depth_max = 0.0
    with ThreadPoolExecutor(max_workers=1) as writer:
        jobs = []
        submit = writer.submit if primary else (lambda *a: None)
        for i, view in enumerate(evaluate(render_fn, samples, img_wh,
                                          lpips_model)):
            jobs.append(submit(
                _write, "jpg", os.path.join(out_dir, f"image{i:03d}.jpg"),
                io.to8b(view.rgb)))
            if view.depth is not None:
                path = os.path.join(out_dir, f"depth_raw{i:03d}.npz")
                jobs.append(submit(_write, "npz", path, view.depth))
                depth_files.append(path)
                depth_max = max(depth_max, float(np.nanmax(view.depth)))
            if video:
                frames.append(view.rgb)
            vals["psnr"].append(view.psnr)
            vals["ssim"].append(view.ssim)
            if view.psnr_obj is not None:
                vals["psnr_obj"].append(view.psnr_obj)
            if view.lpips is not None:
                vals["lpips"].append(view.lpips)
        for job in jobs:
            if job is not None:
                job.result()  # raise the first write error, if any
    summary = {k: float(np.mean(v)) for k, v in vals.items() if v}
    if not primary:
        return summary
    if depth_files:
        import cv2
        for i, path in enumerate(depth_files):
            with np.load(path) as data:
                img = io.depth_jet(data["depth"], depth_max or 1.0)
            cv2.imwrite(os.path.join(out_dir, f"depth_img{i:03d}.jpg"), img)
    if frames:
        io.store_video(out_dir, frames)
    if results_json is not None:
        payload = {k: {"mean": v, "views": vals[k]}
                   for k, v in summary.items()}
        if not vals["lpips"]:
            payload["lpips_status"] = "skipped: no pretrained weights"
        payload.update(extra or {})
        io.write_stats(results_json, **payload)
    return summary


def spiral_pose(pose: np.ndarray, progress: float,
                radii: float = 0.03) -> np.ndarray:
    """`pose` moved along a small camera spiral (the reference's
    move_camera_pose, datasets/nerds360.py:156-163): `progress` in [0, 1)
    is two turns."""
    t = progress * np.pi * 4
    center = np.array([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * radii
    out = pose.copy()
    out[:3, 3] = out[:3, 3] + out[:3, :3] @ center
    return out


def trajectory_360(ref_pose: np.ndarray, n_frames: int = 40) -> np.ndarray:
    """(n_frames, ...) spiral poses around `ref_pose` for the 360
    flythrough."""
    return np.stack([spiral_pose(ref_pose, i / n_frames)
                     for i in range(n_frames)])
