"""Host-side contour extraction & convex region growing.

Equivalent of the reference's CGAL/OpenCV stages
(plane_segmentation/convex_plane_decomposition/src/contour_extraction/
ContourExtraction.cpp:28-142, ConvexRegionGrowing.cpp:151-216,
Upsampling.cpp:31-68): label upsampling, per-label boundary/inset polygon
extraction, and growing a convex N-gon inside a polygon-with-holes. These are
controller-facing outputs computed per publish, not per step — they stay on
host (numpy + cv2), matching the reference's CPU placement.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "BoundaryWithHoles",
    "project_to_planar_region",
    "PlanarRegion",
    "upsample_labels",
    "extract_boundaries",
    "grow_convex_polygon",
]


@dataclasses.dataclass
class BoundaryWithHoles:
    boundary: np.ndarray           # (N, 2) outer ring, image coords
    holes: List[np.ndarray]        # inner rings


@dataclasses.dataclass
class PlanarRegion:
    label: int
    normal: np.ndarray             # (3,)
    support: np.ndarray            # (3,)
    boundary_with_holes: BoundaryWithHoles
    insets: List[np.ndarray]       # inset rings after margin erosion
    transform_plane_to_world: Optional[np.ndarray] = None  # (4, 4)


def upsample_labels(labels: np.ndarray, factor: int = 3) -> np.ndarray:
    """Nearest-neighbor label upsampling (Upsampling.cpp:31-68)."""
    return np.repeat(np.repeat(labels, factor, axis=0), factor, axis=1)


def _find_contours(mask: np.ndarray) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """(outer rings, hole rings) via cv2 RETR_CCOMP, with a pure-numpy marching
    fallback when cv2 is unavailable."""
    try:
        import cv2 as cv

        contours, hierarchy = cv.findContours(
            mask.astype(np.uint8), cv.RETR_CCOMP, cv.CHAIN_APPROX_SIMPLE
        )
        outers, holes = [], []
        if hierarchy is None:
            return outers, holes
        for c, h in zip(contours, hierarchy[0]):
            ring = c[:, 0, ::-1].astype(np.float64)  # (N, 2) as (row, col)
            if h[3] < 0:
                outers.append(ring)
            else:
                holes.append(ring)
        return outers, holes
    except ImportError:
        ys, xs = np.where(mask > 0)
        if len(ys) == 0:
            return [], []
        ring = np.array(
            [
                [ys.min(), xs.min()],
                [ys.min(), xs.max()],
                [ys.max(), xs.max()],
                [ys.max(), xs.min()],
            ],
            np.float64,
        )
        return [ring], []


def _erode(mask: np.ndarray, radius: int) -> np.ndarray:
    if radius <= 0:
        return mask
    try:
        import cv2 as cv

        kernel = cv.getStructuringElement(cv.MORPH_ELLIPSE, (2 * radius + 1, 2 * radius + 1))
        return cv.erode(mask.astype(np.uint8), kernel)
    except ImportError:
        out = mask.astype(bool)
        for _ in range(radius):
            p = np.pad(out, 1, constant_values=False)
            out = (
                p[1:-1, 1:-1] & p[:-2, 1:-1] & p[2:, 1:-1] & p[1:-1, :-2] & p[1:-1, 2:]
            )
        return out.astype(np.uint8)


def extract_boundaries(
    labels: np.ndarray,
    plane_normals: np.ndarray,
    plane_support: np.ndarray,
    plane_valid: np.ndarray,
    resolution: float,
    map_origin: Sequence[float] = (0.0, 0.0),
    upsample: int = 3,
    margin_cells: int = 1,
    inset_cells: int = 2,
) -> List[PlanarRegion]:
    """Per-label boundary + inset polygons in world coordinates
    (ContourExtraction.cpp:28-142)."""
    up = upsample_labels(labels, upsample)
    res_up = resolution / upsample
    regions: List[PlanarRegion] = []
    for label in np.unique(labels):
        if label == 0 or not plane_valid[label]:
            continue
        mask = (up == label).astype(np.uint8)
        mask = _erode(mask, margin_cells)
        if mask.sum() == 0:
            continue
        outers, holes = _find_contours(mask)
        if not outers:
            continue
        # largest outer ring is the region boundary
        outer = max(outers, key=lambda r: len(r))
        inset_mask = _erode(mask, inset_cells)
        inset_rings, _ = _find_contours(inset_mask)

        def to_world(ring: np.ndarray) -> np.ndarray:
            # pixel → world (the reference's pixel→world + gravity projection,
            # ContourExtraction.cpp:139-142): row/col scaled by upsampled res
            w = np.empty_like(ring)
            w[:, 0] = map_origin[0] - ring[:, 0] * res_up
            w[:, 1] = map_origin[1] - ring[:, 1] * res_up
            return w

        regions.append(
            PlanarRegion(
                label=int(label),
                normal=np.asarray(plane_normals[label]),
                support=np.asarray(plane_support[label]),
                boundary_with_holes=BoundaryWithHoles(
                    boundary=to_world(outer), holes=[to_world(h) for h in holes]
                ),
                insets=[to_world(r) for r in inset_rings],
            )
        )
    return regions


# ---------------------------------------------------------------------------
# convex region growing (ConvexRegionGrowing.cpp:151-216)
# ---------------------------------------------------------------------------

def _point_in_poly(pt: np.ndarray, poly: np.ndarray) -> bool:
    x, y = pt
    inside = False
    n = len(poly)
    j = n - 1
    for i in range(n):
        xi, yi = poly[i]
        xj, yj = poly[j]
        if (yi > y) != (yj > y) and x < (xj - xi) * (y - yi) / (yj - yi + 1e-30) + xi:
            inside = not inside
        j = i
    return inside


def _is_convex(poly: np.ndarray) -> bool:
    n = len(poly)
    sign = 0
    for i in range(n):
        a, b, c = poly[i], poly[(i + 1) % n], poly[(i + 2) % n]
        cr = (b[0] - a[0]) * (c[1] - b[1]) - (b[1] - a[1]) * (c[0] - b[0])
        if abs(cr) < 1e-12:
            continue
        s = 1 if cr > 0 else -1
        if sign == 0:
            sign = s
        elif s != sign:
            return False
    return True


def grow_convex_polygon(
    boundary: np.ndarray,
    holes: List[np.ndarray],
    seed: np.ndarray,
    n_vertices: int = 16,
    max_iter: int = 1000,
    growth: float = 1.05,
    init_radius: float = 0.02,
) -> Optional[np.ndarray]:
    """Grow a convex N-gon inside a polygon-with-holes from a seed point by
    iterative radial vertex pushing with convexity + containment checks."""
    if not _point_in_poly(seed, boundary):
        return None
    for h in holes:
        if _point_in_poly(seed, h):
            return None

    angles = np.linspace(0, 2 * np.pi, n_vertices, endpoint=False)
    radii = np.full(n_vertices, init_radius)
    frozen = np.zeros(n_vertices, bool)

    def vertex(i, r):
        return seed + r * np.array([np.cos(angles[i]), np.sin(angles[i])])

    def ok(poly):
        if not _is_convex(poly):
            return False
        for p in poly:
            if not _point_in_poly(p, boundary):
                return False
            for h in holes:
                if _point_in_poly(p, h):
                    return False
        return True

    poly = np.array([vertex(i, radii[i]) for i in range(n_vertices)])
    if not ok(poly):
        return None
    for it in range(max_iter):
        if frozen.all():
            break
        i = it % n_vertices
        if frozen[i]:
            continue
        new_r = radii[i] * growth + 1e-3
        cand = poly.copy()
        cand[i] = vertex(i, new_r)
        if ok(cand):
            radii[i] = new_r
            poly = cand
        else:
            frozen[i] = True
    return poly


# ---------------------------------------------------------------------------
# segmented plane projection (SegmentedPlaneProjection.cpp:56-97)
# ---------------------------------------------------------------------------

def _closest_point_on_ring(p: np.ndarray, ring: np.ndarray) -> Tuple[float, np.ndarray]:
    """Distance to the ring and the closest point ON the ring edges."""
    best_d, best_p = np.inf, ring[0]
    for i in range(len(ring)):
        a, b = ring[i], ring[(i + 1) % len(ring)]
        ab = b - a
        t = float(np.clip(np.dot(p - a, ab) / max(np.dot(ab, ab), 1e-30), 0.0, 1.0))
        q = a + t * ab
        d = float(np.linalg.norm(p - q))
        if d < best_d:
            best_d, best_p = d, q
    return best_d, np.asarray(best_p, np.float64)


def project_to_planar_region(
    query_xy: np.ndarray, regions: Sequence["PlanarRegion"]
) -> Optional[Tuple["PlanarRegion", np.ndarray]]:
    """Find the best planar region for a query point and project onto its
    plane (getBestPlanarRegionAtPositionInWorld + projectToPlanarRegion,
    SegmentedPlaneProjection.cpp:56-97): a region containing the query wins
    at distance 0; otherwise the query projects to the closest point on the
    region's edges — the HOLE's edges when the query sits inside a hole
    (:79-85), the outer ring's otherwise. Returns (region, projected 3D point)."""
    best = None
    best_d = np.inf
    best_xy = None
    for region in regions:
        ring = region.boundary_with_holes.boundary
        holes = region.boundary_with_holes.holes
        if _point_in_poly(query_xy, ring):
            inside_hole = next(
                (h for h in holes if _point_in_poly(query_xy, h)), None
            )
            if inside_hole is None:
                d, pxy = 0.0, query_xy
            else:
                d, pxy = _closest_point_on_ring(query_xy, inside_hole)
        else:
            d, pxy = _closest_point_on_ring(query_xy, ring)
        if d < best_d:
            best, best_d, best_xy = region, d, np.asarray(pxy, np.float64)
    if best is None:
        return None
    n, s = best.normal, best.support
    z = s[2] - (n[0] * (best_xy[0] - s[0]) + n[1] * (best_xy[1] - s[1])) / max(n[2], 1e-9)
    return best, np.array([best_xy[0], best_xy[1], z])
