"""The comparison that decides `correct`: what the timed path produced,
against the architecture's plain reference (its adapter's
`reference_train` and `reference_render`, architectures/) run on the same
seeded weights and inputs once the window has closed. What follows is
shared by every architecture.

Training cells (the first three items, which set-up drives through the
window's own call and which the window then continues from):
- `loss_gap`: the widest relative gap of a ray step's loss;
- `loss_gap_first`: the same, of the first step alone;
- `moment_gap`: after the first item, the worst leaf's gap between the
  norms of Adam's first moment (for a leaf stepped once, 0.1 x its clipped
  gradient), over max(the reference leaf's norm, the median leaf's);
  `moment_gap_median` the median leaf's;
- `change_gap`, `change_gap_median`: after the third item, the same of
  the norms of the parameters' change.
Both leave out leaves whose reference first moment is under a thousandth
of the median leaf's (their gradient is nought to rounding, as a bias
ahead of a BatchNorm or a pillar head's bias under its softmax, and they
move by round-off).
Render cells (a sample, drawn from the seed, of the rays of every view
rendered, warm-up and window): the widest (`rgb_gap`, `depth_gap`),
99th-percentile (`*_p99_gap`), median (`*_p50_gap`) and mean
(`*_mean_gap`) absolute gaps of a ray's colour channels and depth.

A cell's limits live in `limits/<cell>.json` and name the numbers held;
`correct` holds when each of them is finite and at most its limit. The
others are reported only.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

RENDER_SAMPLE = 4096


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tensors.items()}


def leaf_gaps(prog: Dict[str, float], refn: Dict[str, float],
              keep=None) -> Dict[str, float]:
    """Each leaf's gap of norms, over max(the reference leaf's norm, the
    median leaf's)."""
    names = [k for k in refn if keep is None or k in keep]
    med = float(np.median([refn[k] for k in names]))
    return {k: abs(prog[k] - refn[k]) / max(refn[k], med, 1e-30)
            for k in names}


def train_numbers(prog: Dict, reference: Dict):
    """(numbers, notes): prog / reference are {"losses": [...],
    "moments": {name: norm}, "change": {name: norm}}; the notes name the
    worst leaves and the leaves left out."""
    lp, lr = np.asarray(prog["losses"]), np.asarray(reference["losses"])
    if lp.shape != lr.shape:
        raise ValueError(f"{lp.shape} program losses, {lr.shape} reference")
    med = float(np.median(list(reference["moments"].values())))
    keep = {k for k, v in reference["moments"].items() if v >= 1e-3 * med}
    moment = leaf_gaps(prog["moments"], reference["moments"], keep)
    change = leaf_gaps(prog["change"], reference["change"], keep)
    worst = lambda g: max(g, key=g.get)
    numbers = {"loss_gap": float(np.max(np.abs(lp - lr) / np.abs(lr))),
               "loss_gap_first": float(abs(lp[0] - lr[0]) / abs(lr[0])),
               "moment_gap": moment[worst(moment)],
               "moment_gap_median": float(np.median(list(moment.values()))),
               "change_gap": change[worst(change)],
               "change_gap_median": float(np.median(list(change.values())))}
    notes = {"moment_gap": worst(moment), "change_gap": worst(change),
             "left_out": sorted(set(reference["moments"]) - keep)}
    return numbers, notes


def render_sample(n_views: int, n_rays: int, seed: int):
    """(view, ray) pairs of the sample, drawn from the seed."""
    rng = np.random.default_rng([seed, 13])
    total = n_views * n_rays
    flat = rng.choice(total, min(RENDER_SAMPLE, total), replace=False)
    return flat // n_rays, flat % n_rays


def render_numbers(prog: Dict[str, torch.Tensor],
                   reference: Dict[str, torch.Tensor]):
    """(numbers, notes): the widest, 99th-percentile, median and mean
    absolute gaps of the sampled rays' colour (over channels) and
    depth."""
    out = {}
    for k in ("rgb", "depth"):
        gap = (prog[k].float() - reference[k]).abs().reshape(-1)
        out[f"{k}_gap"] = float(gap.max())
        out[f"{k}_p99_gap"] = float(torch.quantile(gap, 0.99))
        out[f"{k}_p50_gap"] = float(torch.quantile(gap, 0.5))
        out[f"{k}_mean_gap"] = float(gap.mean())
    return out, {}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{"correct", "checks": {name: {"value", "limit"}}} over the limited
    numbers (the others are only reported); a limit without a number is
    not correct."""
    checks = {k: {"value": numbers.get(k), "limit": limits[k]}
              for k in sorted(limits)}
    ok = all(c["value"] is not None and c["limit"] is not None
             and math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return {"correct": ok, "checks": checks}
