"""FLAME 2023 topology constants.

Vertex-index tables for the custom semantic regions of the FLAME head mesh
(5023 vertices, 9976 faces). These are *data* — properties of the public FLAME
topology, identical in every implementation (reference:
`flame_model/flame.py:641-815`) — not algorithms. Only the regions the
framework actually consumes are included: the lip rings (teeth synthesis),
iris/eyelid-free regions, and the reference's innovation-1 vertex ranges.

The coarse part masks (face/neck/scalp/…) ship in FLAME's `FLAME_masks.pkl`,
which is not redistributable; `assets.convert_flame_pickle` imports them when
the user supplies the file.
"""
from __future__ import annotations

import numpy as np

NUM_VERTS = 5023
NUM_FACES = 9976

# 15-vertex lip contour rings (left → right order matters: teeth vertices are
# synthesised pointwise from these).
LIP_OUTSIDE_RING_UPPER = np.array(
    [1713, 1715, 1716, 1735, 1696, 1694, 1657, 3543, 2774, 2811, 2813, 2850,
     2833, 2832, 2830], np.int32)
LIP_OUTSIDE_RING_LOWER = np.array(
    [1576, 1577, 1773, 1774, 1795, 1802, 1865, 3503, 2948, 2905, 2898, 2881,
     2880, 2713, 2712], np.int32)
LIP_INSIDE_RING_UPPER = np.array(
    [1595, 1746, 1747, 1742, 1739, 1665, 1666, 3514, 2783, 2782, 2854, 2857,
     2862, 2861, 2731], np.int32)
LIP_INSIDE_RING_LOWER = np.array(
    [1572, 1573, 1860, 1862, 1830, 1835, 1852, 3497, 2941, 2933, 2930, 2945,
     2943, 2709, 2708], np.int32)

# Region vertex *ranges* used by the region-adaptive loss
# (`innovations/region_adaptive_loss.py:28-37` — "derived from the public
# FLAME topology"): eyeball and nose/mouth vertex blocks.
REGION_RANGES = {
    "eyes_left": (3997, 4067),
    "eyes_right": (3930, 3997),
    "mouth": (2812, 3025),
    "nose": (3325, 3450),
}

# Iris rings (eyeball centre caps).
LEFT_IRIS = np.arange(3931, 4059, dtype=np.int32)
RIGHT_IRIS = np.arange(4477, 4605, dtype=np.int32)


def builtin_vertex_masks() -> dict[str, np.ndarray]:
    """All custom masks available without FLAME_masks.pkl: the reference's
    full explicitly-enumerated region set (`regions.CUSTOM_REGIONS`,
    `flame_model/flame.py:641-815`) plus their list-only unions, with this
    module's legacy aliases kept for the teeth-synthesis and
    region-adaptive-loss consumers."""
    from .regions import CUSTOM_REGIONS, derived_regions

    masks = {k: np.asarray(v, np.int32) for k, v in CUSTOM_REGIONS.items()}
    masks.update(derived_regions(masks))
    masks.update({
        "lip_outside_ring_upper": LIP_OUTSIDE_RING_UPPER,
        "lip_outside_ring_lower": LIP_OUTSIDE_RING_LOWER,
        "lip_inside_ring_upper": LIP_INSIDE_RING_UPPER,
        "lip_inside_ring_lower": LIP_INSIDE_RING_LOWER,
        **{
            name: np.arange(lo, hi, dtype=np.int32)
            for name, (lo, hi) in REGION_RANGES.items()
        },
    })
    return masks
