"""Few-shot evaluation: render every test view, PSNR / SSIM (and, with
pretrained LPIPS weights, LPIPS) on the device, stream artifacts to disk
(port of neo360_tpu/train/eval.py:42-52, 55-90, 100-236).

`evaluate` yields one `ViewResult` per view and holds nothing else, so
memory stays constant in the number of views. `evaluate_and_save` writes
each view's JPEG and raw depth on a writer thread while the next view
renders, then results.json. PIL is imported only by the writer.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
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


def _write(kind: str, path: str, arr: np.ndarray) -> None:
    if kind == "jpg":
        from PIL import Image
        Image.fromarray(arr).save(path)
    else:
        np.savez_compressed(path, depth=arr)


def evaluate_and_save(render_fn, samples, img_wh, out_dir: str,
                      results_json: Optional[str] = None,
                      extra: Optional[Dict[str, str]] = None,
                      lpips_model=None) -> Dict[str, float]:
    """`evaluate` + image{i}.jpg / depth_raw{i}.npz under `out_dir`, and
    each metric's mean and per-view values in `results_json` (without a
    pretrained `lpips_model`, "lpips_status" says LPIPS was skipped).
    Returns the means {psnr, ssim[, psnr_obj][, lpips]}."""
    os.makedirs(out_dir, exist_ok=True)
    vals: Dict[str, List[float]] = {"psnr": [], "ssim": [], "psnr_obj": [],
                                    "lpips": []}
    with ThreadPoolExecutor(max_workers=1) as writer:
        jobs = []
        for i, view in enumerate(evaluate(render_fn, samples, img_wh,
                                          lpips_model)):
            jobs.append(writer.submit(
                _write, "jpg", os.path.join(out_dir, f"image{i:03d}.jpg"),
                io.to8b(view.rgb)))
            if view.depth is not None:
                jobs.append(writer.submit(
                    _write, "npz",
                    os.path.join(out_dir, f"depth_raw{i:03d}.npz"),
                    view.depth))
            vals["psnr"].append(view.psnr)
            vals["ssim"].append(view.ssim)
            if view.psnr_obj is not None:
                vals["psnr_obj"].append(view.psnr_obj)
            if view.lpips is not None:
                vals["lpips"].append(view.lpips)
        for job in jobs:
            job.result()  # raise the first write error, if any
    summary = {k: float(np.mean(v)) for k, v in vals.items() if v}
    if results_json is not None:
        payload = {k: {"mean": v, "views": vals[k]}
                   for k, v in summary.items()}
        if not vals["lpips"]:
            payload["lpips_status"] = "skipped: no pretrained weights"
        payload.update(extra or {})
        io.write_stats(results_json, **payload)
    return summary
