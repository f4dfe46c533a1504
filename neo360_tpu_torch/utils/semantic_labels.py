"""Parallel-Domain semantic label table of NERDS360 (port of
neo360_tpu/utils/semantic_labels.py; the reference's
utils/semantic_labels.py:17-150).

The NERDS360 evaluation uses id 5 ("Car") for instance masks and object
PSNR, and the visualization tooling 24 ("Road").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class Label:
    name: str
    id: int
    cuboid_id: int
    is_thing: bool
    color: Tuple[int, int, int]


LABELS = [
    Label("Animal", 0, -1, True, (220, 20, 180)),
    Label("Bicycle", 1, 8, True, (119, 11, 32)),
    Label("Bicyclist", 2, 0, True, (64, 64, 64)),
    Label("Building", 3, -1, False, (70, 70, 70)),
    Label("Bus", 4, 3, True, (0, 60, 100)),
    Label("Car", 5, 2, True, (0, 0, 142)),
    Label("Caravan/RV", 6, 3, True, (0, 0, 90)),
    Label("ConstructionVehicle", 7, -1, True, (32, 32, 32)),
    Label("CrossWalk", 8, -1, True, (255, 255, 255)),
    Label("Fence", 9, -1, False, (190, 153, 153)),
    Label("HorizontalPole", 10, -1, True, (153, 153, 153)),
    Label("LaneMarking", 11, -1, False, (220, 220, 220)),
    Label("LimitLine", 12, -1, False, (180, 180, 180)),
    Label("Motorcycle", 13, 4, True, (0, 0, 230)),
    Label("Motorcyclist", 14, 11, True, (128, 128, 128)),
    Label("OtherDriveableSurface", 15, -1, False, (80, 0, 0)),
    Label("OtherFixedStructure", 16, -1, False, (150, 0, 0)),
    Label("OtherMovable", 17, -1, True, (230, 0, 0)),
    Label("OtherRider", 18, -1, True, (192, 192, 192)),
    Label("Overpass/Bridge/Tunnel", 19, -1, False, (150, 100, 100)),
    Label("OwnCar(EgoCar)", 20, 2, False, (128, 230, 128)),
    Label("ParkingMeter", 21, -1, False, (32, 32, 32)),
    Label("Pedestrian", 22, 0, True, (220, 20, 60)),
    Label("Railway", 23, -1, False, (230, 150, 140)),
    Label("Road", 24, -1, False, (128, 64, 128)),
    Label("RoadBarriers", 25, -1, False, (80, 80, 80)),
    Label("RoadBoundary(Curb)", 26, -1, False, (100, 100, 100)),
    Label("RoadMarking", 27, -1, False, (255, 220, 0)),
    Label("SideWalk", 28, -1, False, (244, 35, 232)),
    Label("Sky", 29, -1, False, (70, 130, 180)),
    Label("TemporaryConstructionObject", 30, -1, True, (255, 160, 20)),
    Label("Terrain", 31, -1, False, (81, 0, 81)),
    Label("TowedObject", 32, 9, True, (0, 0, 110)),
    Label("TrafficLight", 33, -1, True, (250, 170, 30)),
    Label("TrafficSign", 34, -1, True, (220, 220, 0)),
    Label("Train", 35, 6, True, (0, 80, 100)),
    Label("Truck", 36, 1, True, (0, 0, 70)),
    Label("Vegetation", 37, -1, False, (107, 142, 35)),
    Label("VerticalPole", 38, -1, True, (153, 153, 153)),
    Label("WheeledSlow", 39, 5, True, (0, 64, 64)),
    Label("LaneMarkingOther", 40, -1, False, (255, 255, 0)),
    Label("LaneMarkingGap", 41, -1, False, (0, 255, 255)),
    Label("Fence(Transparent)", 42, -1, False, (85, 75, 75)),
]

NAME_TO_LABEL: Dict[str, Label] = {l.name: l for l in LABELS}
ID_TO_LABEL: Dict[int, Label] = {l.id: l for l in LABELS}

CAR_ID = NAME_TO_LABEL["Car"].id          # 5
ROAD_ID = NAME_TO_LABEL["Road"].id        # 24


def colorize_semantic(seg) -> np.ndarray:
    """(H, W) id map -> (H, W, 3) uint8 colour image (ids outside the
    table stay black)."""
    seg = np.asarray(seg)
    out = np.zeros(seg.shape + (3,), dtype=np.uint8)
    for label in LABELS:
        out[seg == label.id] = label.color
    return out
