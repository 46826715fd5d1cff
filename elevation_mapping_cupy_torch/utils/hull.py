"""Host-side convex hull (Andrew monotone chain).

A copy of ``elevation_mapping_cupy_tpu/utils/hull.py``: it replaces the
reference's shapely MultiPoint(...).convex_hull (traversability_polygon.py:46-53)
without the shapely dependency. Used for the untraversable-polygon output of
polygon safety queries — controller-facing and tiny, so it stays on host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["convex_hull"]


def convex_hull(points: np.ndarray) -> Optional[np.ndarray]:
    """points: (N, 2). Returns closed hull vertex ring (M, 2) ordered CCW with
    the first point repeated last (shapely exterior.coords convention), or
    None when the hull degenerates to a point/segment (reference returns None
    for Point/LineString geometries)."""
    # np.unique(axis=0) already returns rows in lexicographic order
    pts = np.unique(np.asarray(points, dtype=np.float64), axis=0)
    if len(pts) < 3:
        return None

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(tuple(p))
    upper = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(tuple(p))
    hull = lower[:-1] + upper[:-1]
    if len(hull) < 3:
        return None
    ring = np.asarray(hull + [hull[0]], dtype=np.float64)
    return ring
