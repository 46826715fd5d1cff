"""Per-cell stencil ops: dilation fill, surface normals, min/max/smooth filters.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/ops/stencil.py``
(reference CUDA kernels dilation_filter_kernel, custom_kernels.py:392-449,
with its ``dx + dy`` "distance" and flat-index row wrap; normal_filter_kernel,
custom_kernels.py:452-506; the min_filter / max_filter plugins,
plugins/min_filter.py:29-118 and max_filter.py:36-113, with their 0.6 fill
sentinel; the smooth_filter plugin, smooth_filter.py:48-59). Each static
neighbourhood offset of the dilation and the normals is one shifted copy of
the flat grid. The min/max filters gather a whole (2s+1)^2 neighbourhood at
once through a table built once per (cell_n, size), so an iteration costs a
handful of launches instead of ~8 per offset.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from .geometry import true_div

__all__ = ["dilation_fill", "surface_normals", "min_filter", "max_filter", "uniform_smooth"]


def _flat_neighbor(fm: torch.Tensor, off: int, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat-index neighbor i+off of a (..., n*n) grid with the reference's
    bounds semantics: valid iff 0 <= i+off < n*n and the decomposed (row,
    col) is interior. Rolled values that wrap are masked out by
    ``in_range``."""
    nn_ = n * n
    i = torch.arange(nn_, device=fm.device)
    j = i + off
    in_range = (j >= 0) & (j < nn_)
    jc = torch.clamp(j, 0, nn_ - 1)
    jx = jc // n
    jy = jc % n
    interior = (jx > 0) & (jx < n - 1) & (jy > 0) & (jy < n - 1)
    return torch.roll(fm, -off, dims=-1), in_range & interior


def dilation_fill(
    map2d: torch.Tensor, mask: torch.Tensor, size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fill invalid cells from the neighbor minimizing dx+dy (ties: scan
    order, by the strict ``<``). Returns (filled map, updated mask). Maps
    are (..., H, W); leading axes are a batch."""
    n = map2d.shape[-1]
    fm = map2d.flatten(-2)
    fmask = mask.flatten(-2)

    best_dist = torch.full_like(fm, 100.0)
    best_val = torch.zeros_like(fm)
    for dy in range(-size, size + 1):
        for dx in range(-size, size + 1):
            val, ok = _flat_neighbor(fm, n * dy + dx, n)
            nb_mask = torch.roll(fmask, -(n * dy + dx), dims=-1)
            cand = ok & (nb_mask > 0.5) & ((dx + dy) < best_dist)
            best_dist = torch.where(cand, float(dx + dy), best_dist)
            best_val = torch.where(cand, val, best_val)

    invalid = fmask < 0.5
    found = invalid & (best_dist < 100.0)
    out = torch.where(found, best_val, fm)
    out_mask = torch.where(found, 1.0, fmask)
    return out.reshape(map2d.shape), out_mask.reshape(map2d.shape)


def surface_normals(map2d: torch.Tensor, mask: torch.Tensor, resolution: float) -> torch.Tensor:
    """Forward-difference normals (normal_filter_kernel). Returns (..., 3,
    H, W) for (..., H, W) maps."""
    n = map2d.shape[-1]
    fm = map2d.flatten(-2)
    fmask = mask.flatten(-2)
    hx, okx = _flat_neighbor(fm, 1, n)
    hy, oky = _flat_neighbor(fm, n, n)
    ok = (fmask > 0.5) & okx & oky
    dzdx = hx - fm
    dzdy = hy - fm
    nx = -dzdy / resolution
    ny = -dzdx / resolution
    norm = torch.sqrt(nx * nx + ny * ny + 1.0)
    out = torch.stack([nx / norm, ny / norm, 1.0 / norm], dim=-2)
    return torch.where(ok[..., None, :], out, 0.0).reshape(*map2d.shape[:-2], 3, n, n)


@functools.lru_cache(maxsize=16)
def _neighbor_table(n: int, size: int, device: torch.device) -> torch.Tensor:
    """(k*k, n*n) flat indices of every cell's neighbours at the offsets
    n*dy + dx, dy and dx in [-size, size], with ``_flat_neighbor``'s rules:
    a neighbour is usable iff 0 <= i+off < n*n and its decomposed (row, col)
    is interior. Unusable entries point at n*n, one past the grid, where the
    caller puts its neutral value."""
    nn_ = n * n
    i = torch.arange(nn_, device=device)
    rows = []
    for dy in range(-size, size + 1):
        for dx in range(-size, size + 1):
            j = i + (n * dy + dx)
            in_range = (j >= 0) & (j < nn_)
            jc = torch.clamp(j, 0, nn_ - 1)
            jx = jc // n
            jy = jc % n
            ok = in_range & (jx > 0) & (jx < n - 1) & (jy > 0) & (jy < n - 1)
            rows.append(torch.where(ok, jc, nn_))
    return torch.stack(rows)


def _extreme_filter(
    map2d: torch.Tensor, mask: torch.Tensor, size: int, iterations: int, mode: str
) -> torch.Tensor:
    """Shared body of min_filter/max_filter (the JAX package's
    ``_extreme_filter``), with its semantics:

      * min_filter re-fills every *originally* invalid cell each iteration,
        so min values keep propagating; max_filter tests its own evolving
        mask and fills each cell once;
      * iterations stop changing anything once every cell is filled (the
        ``done`` gate, a 0-d tensor: no read-back per iteration);
      * Jacobi (previous-iteration snapshot) neighbour reads;
      * filled cells get the mask value 0.6; cells whose final mask is
        <= 0.5 come out NaN.

    Min and max do not depend on the order of their operands, so one gather
    of the whole neighbourhood and one reduction give the offset loop's
    result bit for bit (a NaN neighbour propagates in both)."""
    n = map2d.shape[-1]
    fm = map2d.reshape(-1)
    fmask = mask.reshape(-1)
    init = torch.tensor([math.inf if mode == "min" else -math.inf], dtype=fm.dtype, device=fm.device)
    table = _neighbor_table(n, size, fm.device)
    orig_invalid = fmask < 0.5
    for _ in range(iterations):
        done = torch.all(fmask > 0.5)
        usable = torch.cat([torch.where(fmask > 0.5, fm, init), init])
        nb = usable[table]
        best = nb.amin(dim=0) if mode == "min" else nb.amax(dim=0)
        fill_target = orig_invalid if mode == "min" else (fmask < 0.5)
        found = ~done & fill_target & torch.isfinite(best)
        fm = torch.where(found, best, fm)
        fmask = torch.where(found, 0.6, fmask)  # reference fill sentinel
    out = torch.where(fmask > 0.5, fm, math.nan)
    return out.reshape(n, n)


def min_filter(map2d: torch.Tensor, mask: torch.Tensor, size: int = 5, iterations: int = 5) -> torch.Tensor:
    return _extreme_filter(map2d, mask, size, iterations, "min")


def max_filter(map2d: torch.Tensor, mask: torch.Tensor, size: int = 5, iterations: int = 5) -> torch.Tensor:
    return _extreme_filter(map2d, mask, size, iterations, "max")


def symmetric_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """Source index of each of the n + 2*pad entries of numpy's
    ``pad(mode="symmetric")`` along one axis: the edge is repeated, and a
    pad wider than the axis keeps reflecting (period 2n)."""
    j = torch.remainder(torch.arange(-pad, n + pad, device=device), 2 * n)
    return torch.where(j >= n, 2 * n - 1 - j, j)


def uniform_smooth(map2d: torch.Tensor, passes: int = 2, size: int = 3) -> torch.Tensor:
    """size x size uniform filter with numpy's symmetric boundary, applied
    ``passes`` times (smooth_filter.py:58-59); the window is summed in the
    JAX package's order."""
    pad = size // 2
    H, W = map2d.shape
    rows = symmetric_index(H, pad, map2d.device)
    cols = symmetric_index(W, pad, map2d.device)
    out = map2d
    for _ in range(passes):
        x = out[rows][:, cols]
        acc = torch.zeros_like(map2d)
        for dy in range(size):
            for dx in range(size):
                acc = acc + x[dy : dy + H, dx : dx + W]
        out = true_div(acc, float(size * size))
    return out
