"""Per-cell stencil ops: dilation fill and surface normals.

PyTorch counterpart of ``dilation_fill`` and ``surface_normals`` in
``elevation_mapping_cupy_tpu/ops/stencil.py`` (reference CUDA kernels
dilation_filter_kernel, custom_kernels.py:392-449, with its ``dx + dy``
"distance" and flat-index row wrap, and normal_filter_kernel,
custom_kernels.py:452-506). Each static neighbourhood offset is one shifted
copy of the flat grid. ``min_filter``, ``max_filter`` and ``uniform_smooth``
come with the plugin slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["dilation_fill", "surface_normals"]


def _flat_neighbor(fm: torch.Tensor, off: int, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat-index neighbor i+off with the reference's bounds semantics:
    valid iff 0 <= i+off < n*n and the decomposed (row, col) is interior.
    Rolled values that wrap are masked out by ``in_range``."""
    nn_ = n * n
    i = torch.arange(nn_, device=fm.device)
    j = i + off
    in_range = (j >= 0) & (j < nn_)
    jc = torch.clamp(j, 0, nn_ - 1)
    jx = jc // n
    jy = jc % n
    interior = (jx > 0) & (jx < n - 1) & (jy > 0) & (jy < n - 1)
    return torch.roll(fm, -off), in_range & interior


def dilation_fill(
    map2d: torch.Tensor, mask: torch.Tensor, size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fill invalid cells from the neighbor minimizing dx+dy (ties: scan
    order, by the strict ``<``). Returns (filled map, updated mask)."""
    n = map2d.shape[-1]
    fm = map2d.reshape(-1)
    fmask = mask.reshape(-1)

    best_dist = torch.full_like(fm, 100.0)
    best_val = torch.zeros_like(fm)
    for dy in range(-size, size + 1):
        for dx in range(-size, size + 1):
            val, ok = _flat_neighbor(fm, n * dy + dx, n)
            nb_mask = torch.roll(fmask, -(n * dy + dx))
            cand = ok & (nb_mask > 0.5) & ((dx + dy) < best_dist)
            best_dist = torch.where(cand, float(dx + dy), best_dist)
            best_val = torch.where(cand, val, best_val)

    invalid = fmask < 0.5
    found = invalid & (best_dist < 100.0)
    out = torch.where(found, best_val, fm)
    out_mask = torch.where(found, 1.0, fmask)
    return out.reshape(n, n), out_mask.reshape(n, n)


def surface_normals(map2d: torch.Tensor, mask: torch.Tensor, resolution: float) -> torch.Tensor:
    """Forward-difference normals (normal_filter_kernel). Returns (3, H, W)."""
    n = map2d.shape[-1]
    fm = map2d.reshape(-1)
    fmask = mask.reshape(-1)
    hx, okx = _flat_neighbor(fm, 1, n)
    hy, oky = _flat_neighbor(fm, n, n)
    ok = (fmask > 0.5) & okx & oky
    dzdx = hx - fm
    dzdy = hy - fm
    nx = -dzdy / resolution
    ny = -dzdx / resolution
    norm = torch.sqrt(nx * nx + ny * ny + 1.0)
    out = torch.stack([nx / norm, ny / norm, 1.0 / norm])
    return torch.where(ok, out, 0.0).reshape(3, n, n)
