"""The work of one item (a stage, a step or a view) at a cell's shapes,
from the configuration file and the traffic: what the FLOP counter and the
roofline families count. It says nothing of how the program launches it.

`Work` fields:
- `encodes`: source stacks encoded (a stage: S; a step: 1; a view: 0,
  the scene is encoded in set-up);
- `batches`: ray batches rendered, each a list of levels (rays, fg
  samples, bg samples, conditioned), with the number of such batches;
- `train`: gradients are taken; `dense_tables`: the tri-plane and local
  maps' gradients are whole maps every step (the per-step trainer) rather
  than added up over the stage;
- the sizes: NV, image, latent map, grid, widths and dtype widths.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class Work:
    nv: int
    image_hw: Tuple[int, int]
    latent_hw: Tuple[int, int]
    grid: Tuple[int, int, int]
    plane_hw: Tuple[int, int]
    encoder_width: int
    lift_width: int
    lift_proj: bool
    plane_dim: int
    local_dim: int
    local_maps: int
    pillar_width: int
    depth_fc_layers: int
    elt: int                    # bytes of the compute dtype
    encodes: int
    batches: List[Tuple[int, List[Tuple[int, int, int, bool]]]] = field(
        default_factory=list)
    train: bool = False
    dense_tables: bool = False

    def conditioned(self):
        """(count, rays, fg samples, bg samples) of every conditioned
        level of the item."""
        return [(count, r, sf, sb) for count, lvls in self.batches
                for r, sf, sb, cond in lvls if cond]

    def all_levels(self):
        return [(count, r, sf, sb) for count, lvls in self.batches
                for r, sf, sb, _ in lvls]


def levels(cfg: Dict, rays: int) -> List[Tuple[int, int, int, bool]]:
    """(rays, fg samples, bg samples, conditioned) of each level."""
    if cfg["use_proposal"]:
        n0 = cfg["num_prop_samples"] + 1
        n1 = cfg["num_fine_samples"] + 1
        return [(rays, n0, n0, False), (rays, n1, n1, True)]
    n0 = cfg["num_coarse_samples"] + 1
    n1 = n0 + cfg["num_fine_samples"]
    return [(rays, n0, n0, True), (rays, n1, n1, True)]


def of(cfg: Dict, kind: str, wh, k: int, s: int, b: int, chunk: int
       ) -> Work:
    """The work of one item of traffic `kind` ("stage", "step", "view")
    at image size wh = (W, H), K steps over S scenes of B rays, tiles of
    `chunk` rays."""
    w, h = wh
    lat = (h // 2, w // 2)
    elt = 2 if cfg["precision"] == "bfloat16" else 4
    base = dict(nv=cfg["num_src_views"], image_hw=(h, w), latent_hw=lat,
                grid=tuple(cfg["grid_size"]), plane_hw=tuple(
                    cfg["plane_hw"]), encoder_width=cfg["encoder_width"],
                lift_width=cfg["lift_dim"] or cfg["encoder_channels"],
                lift_proj=cfg["lift_dim"] is not None,
                plane_dim=cfg["plane_dim"], local_dim=cfg["local_proj_dim"],
                local_maps=1 if cfg["use_proposal"] else 2,
                pillar_width=cfg["pillar_width"],
                depth_fc_layers=cfg["depth_fc_layers"],
                elt=elt)
    if kind == "stage":
        return Work(encodes=s, batches=[(k * s, levels(cfg, b // s))],
                    train=True, **base)
    if kind == "step":
        return Work(encodes=1, batches=[(1, levels(cfg, b))], train=True,
                    dense_tables=True, **base)
    tiles = math.ceil(w * h / chunk)
    return Work(encodes=0, batches=[(tiles, levels(cfg, chunk))], **base)
