"""Polygon rasterization and traversability safety statistics.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/ops/polygon.py``:
polygon_mask_kernel (custom_kernels.py:509-654), the integer-grid ray-casting
point-in-polygon test with its colinear/on-segment special cases, over every
(edge, cell) pair at once, plus the masked traversability statistics of
traversability_polygon.py:10-43. The convex hull of unsafe cells is host
NumPy (``utils/hull.py``).
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

from ..config import MapConfig
from .geometry import true_div

__all__ = ["polygon_mask", "masked_traversability", "polygon_area"]


def _orientation(px, py, qx, qy, rx, ry):
    """0 colinear, 1 clockwise, 2 counterclockwise (int32 math)."""
    val = (qy - py) * (rx - qx) - (qx - px) * (ry - qy)
    return torch.where(val == 0, 0, torch.where(val > 0, 1, 2))


def _on_segment(px, py, qx, qy, rx, ry):
    return (
        (qx <= torch.maximum(px, rx))
        & (qx >= torch.minimum(px, rx))
        & (qy <= torch.maximum(py, ry))
        & (qy >= torch.minimum(py, ry))
    )


def _do_intersect(p1x, p1y, q1x, q1y, p2x, p2y, q2x, q2y):
    o1 = _orientation(p1x, p1y, q1x, q1y, p2x, p2y)
    o2 = _orientation(p1x, p1y, q1x, q1y, q2x, q2y)
    o3 = _orientation(p2x, p2y, q2x, q2y, p1x, p1y)
    o4 = _orientation(p2x, p2y, q2x, q2y, q1x, q1y)
    general = (o1 != o2) & (o3 != o4)
    s1 = (o1 == 0) & _on_segment(p1x, p1y, p2x, p2y, q1x, q1y)
    s2 = (o2 == 0) & _on_segment(p1x, p1y, q2x, q2y, q1x, q1y)
    s3 = (o3 == 0) & _on_segment(p2x, p2y, p1x, p1y, q2x, q2y)
    s4 = (o4 == 0) & _on_segment(p2x, p2y, q1x, q1y, q2x, q2y)
    return general | s1 | s2 | s3 | s4


def _poly_cell(xy: torch.Tensor, center: torch.Tensor, cfg: MapConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """World xy -> (ix, iy) with the kernel's clamped get_idx semantics
    (truncated toward zero, then clamped to the grid). The quotient is one
    IEEE division on every device (``geometry.true_div``)."""
    n = cfg.cell_n
    fx = true_div(xy[..., 0] - center[0], cfg.resolution) + 0.5 * n
    fy = true_div(xy[..., 1] - center[1], cfg.resolution) + 0.5 * n
    ix = torch.clamp(torch.trunc(fx), 0, n - 1).to(torch.int32)
    iy = torch.clamp(torch.trunc(fy), 0, n - 1).to(torch.int32)
    return ix, iy


def polygon_mask(
    polygon: torch.Tensor,                     # (V, 2) world-frame vertices, padded
    n_vertices: Union[int, torch.Tensor],      # actual vertex count
    center_xy: torch.Tensor,                   # (2,)
    cfg: MapConfig,
) -> torch.Tensor:
    """Rasterize a polygon into a (H, W) 0/1 mask (polygon_mask_kernel).
    Every padded edge and every cell in one broadcast (V, n*n) pass; the
    edges past ``n_vertices`` do not count."""
    n = cfg.cell_n
    dev = polygon.device
    i = torch.arange(n * n, device=dev)
    px = (i // n).to(torch.int32)[None, :]
    py = (i % n).to(torch.int32)[None, :]
    ex = torch.full_like(px, 100000)

    vmax = polygon.shape[0]
    vidx = torch.arange(vmax, device=dev)
    n_vertices = torch.as_tensor(n_vertices, device=dev)
    vmask = vidx < n_vertices

    vx, vy = _poly_cell(polygon, center_xy, cfg)
    # next vertex (j + 1) % polygon_n
    nxt = torch.where(vidx + 1 >= n_vertices, 0, vidx + 1)
    wx, wy = vx[nxt], vy[nxt]

    # bbox gate (kernel :612-619)
    pmin = torch.amin(torch.where(vmask[:, None], polygon, math.inf), dim=0)
    pmax = torch.amax(torch.where(vmask[:, None], polygon, -math.inf), dim=0)
    bminx, bminy = _poly_cell(pmin[None], center_xy, cfg)
    bmaxx, bmaxy = _poly_cell(pmax[None], center_xy, cfg)
    in_bbox = (px >= bminx[0]) & (px <= bmaxx[0]) & (py >= bminy[0]) & (py <= bmaxy[0])

    p1x, p1y, p2x, p2y = vx[:, None], vy[:, None], wx[:, None], wy[:, None]   # (V, 1) each
    inter = _do_intersect(p1x, p1y, p2x, p2y, px, py, ex, py)
    colinear = _orientation(p1x, p1y, px, py, p2x, p2y) == 0
    on_seg = colinear & _on_segment(p1x, p1y, px, py, p2x, p2y)
    straddle = ((p1y <= py) & (p2y > py)) | ((p1y > py) & (p2y <= py))
    use = vmask[:, None]
    on_edge = torch.any(use & inter & on_seg, dim=0)
    cnt = torch.sum(use & inter & ~colinear & straddle, dim=0)
    inside = on_edge | ((cnt % 2) == 1)
    return torch.where(in_bbox[0] & inside, 1.0, 0.0).reshape(n, n)


def masked_traversability(
    layers: torch.Tensor, mask: torch.Tensor, traversability: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """traversability_polygon.get_masked_traversability (:10-19)."""
    trav = traversability[1:-1, 1:-1]
    is_valid = layers[2][1:-1, 1:-1]
    m = mask[1:-1, 1:-1]
    untrav = torch.where(is_valid > 0.5, 1.0 - trav, 0.0)
    return untrav * m, is_valid * m


def polygon_area(polygon: torch.Tensor, n_vertices: Union[int, torch.Tensor]) -> torch.Tensor:
    """Shoelace area over the first n_vertices (traversability_polygon.py:37-43)."""
    v = polygon.shape[0]
    idx = torch.arange(v, device=polygon.device)
    n_vertices = torch.as_tensor(n_vertices, device=polygon.device)
    valid = idx < n_vertices
    prev = torch.where(idx == 0, n_vertices - 1, idx - 1)
    p1 = polygon[prev]
    p2 = polygon
    terms = (p1[:, 0] * p2[:, 1] - p1[:, 1] * p2[:, 0]) / 2.0
    return torch.abs(torch.sum(torch.where(valid, terms, 0.0)))
