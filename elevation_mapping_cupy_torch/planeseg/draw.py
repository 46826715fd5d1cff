"""Planar-region debug rendering — Draw.cpp + RosVisualizations parity.

The reference debugs its decomposition two ways:
  * Draw.cpp rasterizes polygons-with-holes onto cv images
    (convex_plane_decomposition/src/Draw.cpp:1-60: ``drawContour`` outlines
    the outer boundary and every hole in one color, ``scaleShape`` scales
    vertices before drawing);
  * RosVisualizations.cpp renders region boundaries and insets as
    LINE_STRIP MarkerArrays in world coordinates with a fixed 7-color
    MATLAB-style palette, one color per region, closing point repeated,
    and a leading DELETEALL marker
    (convex_plane_decomposition_ros/src/RosVisualizations.cpp:37-160,
    published at ConvexPlaneDecompositionRos.cpp:139-159).

Host-side equivalents here: ``render_boundaries`` / ``render_insets``
rasterize over the elevation image (PNG via utils/map_io.py), and
``boundary_markers`` / ``inset_markers`` build the message-level marker
dicts (this repo's messages are plain dataclasses/dicts).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .contour import PlanarRegion

__all__ = [
    "REGION_COLORMAP",
    "region_color",
    "draw_contour",
    "render_boundaries",
    "render_insets",
    "render_decomposition",
    "boundary_markers",
    "inset_markers",
    "save_decomposition_overlay",
]

# RosVisualizations.cpp:41-50 — the 7-color MATLAB-style palette, one color
# per region index (modulo)
REGION_COLORMAP = np.array(
    [
        [0.0000, 0.4470, 0.7410],
        [0.8500, 0.3250, 0.0980],
        [0.9290, 0.6940, 0.1250],
        [0.4940, 0.1840, 0.5560],
        [0.4660, 0.6740, 0.1880],
        [0.6350, 0.0780, 0.1840],
        [0.2500, 0.2500, 0.2500],
    ],
    np.float32,
)


def region_color(idx: int) -> np.ndarray:
    """getColor(id): palette color for region ``idx`` as uint8 RGB."""
    return (REGION_COLORMAP[idx % len(REGION_COLORMAP)] * 255).astype(np.uint8)


def _world_to_px(ring: np.ndarray, map_origin: Sequence[float], res: float) -> np.ndarray:
    """Inverse of contour.extract_boundaries' to_world: world (x, y) →
    fractional (row, col) pixels on a ``res``-resolution grid."""
    px = np.empty_like(np.asarray(ring, np.float64))
    px[:, 0] = (map_origin[0] - ring[:, 0]) / res
    px[:, 1] = (map_origin[1] - ring[:, 1]) / res
    return px


def _raster_segment(img: np.ndarray, r0, c0, r1, c1, color: np.ndarray) -> None:
    """Dense line rasterization (cv2-free drawContours analogue)."""
    n = int(max(abs(r1 - r0), abs(c1 - c0), 1)) + 1
    rr = np.rint(np.linspace(r0, r1, n)).astype(int)
    cc = np.rint(np.linspace(c0, c1, n)).astype(int)
    ok = (rr >= 0) & (rr < img.shape[0]) & (cc >= 0) & (cc < img.shape[1])
    img[rr[ok], cc[ok]] = color


def draw_contour(
    img: np.ndarray,
    ring_px: np.ndarray,
    color: Optional[np.ndarray] = None,
    close: bool = True,
) -> None:
    """Outline a polygon ring (fractional pixel coords) onto an (H, W, 3)
    uint8 image — Draw.cpp::drawContour. ``color=None`` picks a random color
    like the reference's randomColor()."""
    if color is None:
        color = np.random.randint(0, 256, 3).astype(np.uint8)
    ring_px = np.asarray(ring_px, np.float64)
    if len(ring_px) == 0:
        return
    pts = np.vstack([ring_px, ring_px[:1]]) if close else ring_px
    for a, b in zip(pts[:-1], pts[1:]):
        _raster_segment(img, a[0], a[1], b[0], b[1], color)


def _elevation_underlay(elevation: np.ndarray) -> np.ndarray:
    arr = np.asarray(elevation, np.float32)
    finite = arr[np.isfinite(arr)]
    lo = float(finite.min()) if finite.size else 0.0
    hi = float(finite.max()) if finite.size else 1.0
    g = np.clip((np.where(np.isfinite(arr), arr, lo) - lo) / ((hi - lo) or 1.0), 0, 1)
    return np.repeat((g * 255).astype(np.uint8)[..., None], 3, axis=-1)


def render_boundaries(
    elevation: np.ndarray,
    regions: Sequence[PlanarRegion],
    resolution: float,
    map_origin: Sequence[float] = (0.0, 0.0),
    scale: float = 1.0,
) -> np.ndarray:
    """Region boundary + hole outlines over the elevation image, one palette
    color per region (convertBoundariesToRosMarkers rasterized). ``scale``
    multiplies the output size (Draw.cpp::scaleShape)."""
    img = _elevation_underlay(elevation)
    if scale != 1.0:
        img = np.repeat(np.repeat(img, int(scale), 0), int(scale), 1)
    res = resolution / scale
    for i, reg in enumerate(regions):
        color = region_color(i)
        draw_contour(img, _world_to_px(reg.boundary_with_holes.boundary, map_origin, res), color)
        for hole in reg.boundary_with_holes.holes:
            draw_contour(img, _world_to_px(hole, map_origin, res), color)
    return img


def render_insets(
    elevation: np.ndarray,
    regions: Sequence[PlanarRegion],
    resolution: float,
    map_origin: Sequence[float] = (0.0, 0.0),
    scale: float = 1.0,
) -> np.ndarray:
    """Inset outlines (convertInsetsToRosMarkers rasterized): same per-region
    color indexing as the boundaries so the two images correspond."""
    img = _elevation_underlay(elevation)
    if scale != 1.0:
        img = np.repeat(np.repeat(img, int(scale), 0), int(scale), 1)
    res = resolution / scale
    for i, reg in enumerate(regions):
        color = region_color(i)
        for inset in reg.insets:
            draw_contour(img, _world_to_px(inset, map_origin, res), color)
    return img


def render_decomposition(
    elevation: np.ndarray,
    regions: Sequence[PlanarRegion],
    resolution: float,
    map_origin: Sequence[float] = (0.0, 0.0),
    scale: float = 1.0,
) -> np.ndarray:
    """Boundaries + insets in one overlay (the human-inspection image the
    reference pipeline gets debugged with)."""
    img = render_boundaries(elevation, regions, resolution, map_origin, scale)
    res = resolution / scale
    for i, reg in enumerate(regions):
        color = region_color(i)
        for inset in reg.insets:
            draw_contour(img, _world_to_px(inset, map_origin, res), color)
    return img


def _plane_z(reg: PlanarRegion, xy: np.ndarray) -> np.ndarray:
    """Height of the region's plane at world (x, y) — the reference's
    positionInWorldFrameFromPosition2dInPlane via (normal, support)."""
    n = np.asarray(reg.normal, np.float64)
    s = np.asarray(reg.support, np.float64)
    nz = n[2] if abs(n[2]) > 1e-9 else 1e-9
    return s[2] - (n[0] * (xy[:, 0] - s[0]) + n[1] * (xy[:, 1] - s[1])) / nz


def _line_strip(reg: PlanarRegion, ring: np.ndarray, color_idx: int, marker_id: int,
                line_width: float) -> Dict:
    """One LINE_STRIP marker dict (to3dRosMarker): world 3D points with the
    first point repeated to close the polygon."""
    ring = np.asarray(ring, np.float64)
    pts = np.vstack([ring, ring[:1]]) if len(ring) else ring
    z = _plane_z(reg, pts) if len(pts) else np.zeros(0)
    color = REGION_COLORMAP[color_idx % len(REGION_COLORMAP)]
    return {
        "type": "LINE_STRIP",
        "id": marker_id,
        "scale_x": line_width,
        "color": (float(color[0]), float(color[1]), float(color[2]), 1.0),
        "points": np.column_stack([pts, z]) if len(pts) else np.zeros((0, 3)),
    }


def boundary_markers(
    regions: Sequence[PlanarRegion], line_width: float = 0.005
) -> List[Dict]:
    """convertBoundariesToRosMarkers: leading DELETEALL, then per region
    (palette color by region index) one marker for the outer boundary and
    one per hole, ids = position in the buffer."""
    out: List[Dict] = [{"type": "DELETEALL"}]
    for i, reg in enumerate(regions):
        out.append(_line_strip(reg, reg.boundary_with_holes.boundary, i, len(out), line_width))
        for hole in reg.boundary_with_holes.holes:
            out.append(_line_strip(reg, hole, i, len(out), line_width))
    return out


def inset_markers(
    regions: Sequence[PlanarRegion], line_width: float = 0.005
) -> List[Dict]:
    """convertInsetsToRosMarkers: same structure over each region's insets."""
    out: List[Dict] = [{"type": "DELETEALL"}]
    for i, reg in enumerate(regions):
        for inset in reg.insets:
            out.append(_line_strip(reg, inset, i, len(out), line_width))
    return out


def save_decomposition_overlay(
    path: str,
    elevation: np.ndarray,
    regions: Sequence[PlanarRegion],
    resolution: float,
    map_origin: Sequence[float] = (0.0, 0.0),
    scale: float = 1.0,
) -> np.ndarray:
    """Render and write the overlay PNG (cv2 with .npy fallback, like
    utils/map_io.py). Returns the rendered image."""
    img = render_decomposition(elevation, regions, resolution, map_origin, scale)
    written = False
    try:
        import cv2 as cv

        written = bool(cv.imwrite(path, img[..., ::-1]))  # RGB → BGR
    except Exception:
        written = False
    if not written:
        np.save(path + ".npy", img)
    return img
