"""Per-cell stencil ops: dilation fill, surface normals, min/max/smooth filters.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/ops/stencil.py``
(reference CUDA kernels dilation_filter_kernel, custom_kernels.py:392-449,
with its ``dx + dy`` "distance" and flat-index row wrap; normal_filter_kernel,
custom_kernels.py:452-506; the min_filter / max_filter plugins,
plugins/min_filter.py:29-118 and max_filter.py:36-113, with their 0.6 fill
sentinel; the smooth_filter plugin, smooth_filter.py:48-59). On the card the
dilation is one hand-written kernel, ``csrc/dilation_fill.cu``, one launch
for a whole batch; on the CPU its plain version takes one shifted copy of
the grid per neighbourhood offset, as the normals do on both. The min/max
filters gather a whole (2s+1)^2 neighbourhood at once through a table built
once per (H, W, size), so an iteration costs a handful of launches instead
of ~8 per offset. Maps are (H, W), square or not; the dilation and the
normals also work on a block of a larger map (``geometry.Block``), the cells
of one process of a sharded map.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import tracing
from ..kernels import CudaKernel, on_card
from .geometry import Block, true_div

__all__ = [
    "KERNEL", "row_wrap", "dilation_fill", "dilation_fill_reference", "launch_dilation_fill",
    "surface_normals", "min_filter", "max_filter", "uniform_smooth",
]

KERNEL = CudaKernel(
    "dilation_fill.cu",
    "dilation_fill",
    [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2 + [ctypes.c_int32] * 4 + [ctypes.c_int64] * 4
    + [ctypes.c_int32] * 2 + [ctypes.c_void_p],
)
# where the kernel finds a neighbour left or right of the block's columns:
# nowhere, on the row above or below in the same tensors, or in the edges
_NO_EDGE, _WRAP, _GIVEN = 0, 1, 2


def _neighbor_ok(block: Block, dy: int, dx: int, device) -> torch.Tensor:
    """(h, w) bool: whether each cell's flat neighbour at offset
    ``gw * dy + dx`` is usable by the reference's rule: its flat index lies
    in the map and its decomposed (row, col) is interior. Past a row's end
    the flat index goes on at the next row's start."""
    n_cells = block.gh * block.gw
    j = (block.rows(device) + dy) * block.gw + (block.cols(device) + dx)
    in_range = (j >= 0) & (j < n_cells)
    jc = torch.clamp(j, 0, n_cells - 1)
    jx = jc // block.gw
    jy = jc % block.gw
    return in_range & (jx > 0) & (jx < block.gh - 1) & (jy > 0) & (jy < block.gw - 1)


def row_wrap(x: torch.Tensor, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(left, right), each (..., h, size): the cells a flat index reaches
    within ``size`` before each row's start (the previous row's last) and
    past its end (the next row's first) on a block of whole rows; zeros
    where that row is not in the block."""
    w = x.shape[-1]
    zero = torch.zeros_like(x[..., :1, w - size :])
    left = torch.cat([zero, x[..., :-1, w - size :]], dim=-2)
    right = torch.cat([x[..., 1:, :size], zero], dim=-2)
    return left, right


def _check(map2d: torch.Tensor, mask: torch.Tensor, size: int, block: Optional[Block], edges) -> Block:
    """Refuses what neither version of the dilation takes; returns the
    block (default: the whole map)."""
    if map2d.dim() < 2 or mask.shape != map2d.shape:
        raise ValueError(f"map and mask must be one (..., H, W) shape; got {tuple(map2d.shape)} and {tuple(mask.shape)}")
    h, w = map2d.shape[-2:]
    block = Block.whole(h, w) if block is None else block
    if (block.h, block.w) != (h, w):
        raise ValueError(f"the block is {block.h}x{block.w} cells but the maps are {h}x{w}")
    tensors = [map2d, mask]
    if edges is None:
        if w != block.gw and (block.c0 == 0 or block.c0 + w == block.gw):
            raise ValueError("a block at the map's left or right border that is not whole rows needs its edges")
    else:
        want = tuple(map2d.shape[:-2]) + (2, h, size)
        if len(edges) != 2 or any(tuple(e.shape) != want for e in edges):
            raise ValueError(f"edges must be two {want} tensors; got {[tuple(e.shape) for e in edges]}")
        tensors += list(edges)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"the dilation takes float32 tensors; got {[t.dtype for t in tensors]}")
    if any(t.device != map2d.device for t in tensors):
        raise ValueError("map, mask and edges must lie on one device")
    return block


def _rows_contiguous(x: torch.Tensor) -> bool:
    h, w = x.shape[-2:]
    return (w == 1 or x.stride(-1) == 1) and (h == 1 or x.stride(-2) == w)


def dilation_fill(
    map2d: torch.Tensor,
    mask: torch.Tensor,
    size: int,
    block: Optional[Block] = None,
    edges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fill invalid cells from the neighbor minimizing dx+dy (ties: scan
    order, by the strict ``<``). Returns (filled map, updated mask). Maps
    are (..., H, W) float32; leading axes are a batch.

    The neighbours are the reference's flat ones (offset ``W * dy + dx``),
    so at the map's left and right border they lie on the previous or next
    row. ``block`` places the tensors in a larger map (default: they are the
    whole map); a cell whose neighbour lies outside the tensors takes it as
    unusable, which is right only where the neighbour is off the map. A
    block of whole rows finds its wrapped neighbours itself; a block at the
    map's left or right border that is not gives them as ``edges``: the
    (map, mask) pairs stacked on axis -3, (..., 2, H, size), of
    :func:`row_wrap`'s left and right.

    A CUDA tensor goes to the kernel (:func:`launch_dilation_fill`), a CPU
    tensor to :func:`dilation_fill_reference`; both give the same bits."""
    if on_card(map2d, "dilation_fill"):
        return launch_dilation_fill(map2d, mask, size, block, edges)
    return dilation_fill_reference(map2d, mask, size, block, edges)


def launch_dilation_fill(
    map2d: torch.Tensor,
    mask: torch.Tensor,
    size: int,
    block: Optional[Block] = None,
    edges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`dilation_fill` as one launch of ``csrc/dilation_fill.cu`` on
    the current stream. Takes maps whose rows are contiguous, with one
    stride between the maps of the batch (a channel of a (B, C, H, W)
    stack does), contiguous edges and ``0 <= size <= W``; refuses anything
    else, and any tensor not on a card, before the kernel is built."""
    block = _check(map2d, mask, size, block, edges)
    h, w = map2d.shape[-2:]
    if not 0 <= size <= w:
        raise ValueError(f"the kernel takes a size from 0 to the map's width {w}; got {size}")
    if map2d.numel() == 0:
        return map2d.clone(), mask.clone()
    try:
        m3, k3 = map2d.view(-1, h, w), mask.view(-1, h, w)
    except RuntimeError:
        m3 = k3 = None
    if m3 is None or not (_rows_contiguous(m3) and _rows_contiguous(k3)):
        raise ValueError("the dilation kernel needs contiguous rows and one stride between maps")
    if edges is not None and not all(e.is_contiguous() for e in edges):
        raise ValueError("the dilation kernel needs contiguous edges")
    if edges is None:
        left = right = None
        modes = (_WRAP, _WRAP) if w == block.gw else (_NO_EDGE, _NO_EDGE)
    else:
        left, right = (e.data_ptr() for e in edges)
        modes = (_GIVEN if block.c0 == 0 else _NO_EDGE, _GIVEN if block.c0 + w == block.gw else _NO_EDGE)
    out = torch.empty(m3.shape, dtype=torch.float32, device=map2d.device)
    out_mask = torch.empty_like(out)
    KERNEL.launch(
        map2d.device, m3.data_ptr(), k3.data_ptr(), left, right, out.data_ptr(), out_mask.data_ptr(),
        m3.stride(0), k3.stride(0), m3.shape[0], h, w, size,
        *(int(v) for v in (block.r0, block.c0, block.gh, block.gw)), *modes,
    )
    return out.view(map2d.shape), out_mask.view(map2d.shape)


def dilation_fill_reference(
    map2d: torch.Tensor,
    mask: torch.Tensor,
    size: int,
    block: Optional[Block] = None,
    edges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`dilation_fill`: one shifted copy of
    a padded grid per offset, which the tests hold to the JAX package."""
    block = _check(map2d, mask, size, block, edges)
    h, w = map2d.shape[-2:]
    x = torch.stack([map2d, mask], dim=-3)
    if edges is None:
        edges = row_wrap(x, size)
    left = edges[0] if block.c0 == 0 else torch.zeros_like(x[..., :size])
    right = edges[1] if block.c0 + w == block.gw else torch.zeros_like(x[..., :size])
    # a wrapped neighbour lies one row beyond dy
    xp = F.pad(torch.cat([left, x, right], dim=-1), (0, 0, size + 1, size + 1))

    best_dist = torch.full_like(map2d, 100.0)
    best_val = torch.zeros_like(map2d)
    for dy in range(-size, size + 1):
        for dx in range(-size, size + 1):
            nb = xp[..., size + 1 + dy : size + 1 + dy + h, size + dx : size + dx + w]
            ok = _neighbor_ok(block, dy, dx, map2d.device)
            cand = ok & (nb[..., 1, :, :] > 0.5) & ((dx + dy) < best_dist)
            best_dist = torch.where(cand, float(dx + dy), best_dist)
            best_val = torch.where(cand, nb[..., 0, :, :], best_val)

    invalid = mask < 0.5
    found = invalid & (best_dist < 100.0)
    out = torch.where(found, best_val, map2d)
    out_mask = torch.where(found, 1.0, mask)
    return out, out_mask


def surface_normals(
    map2d: torch.Tensor, mask: torch.Tensor, resolution: float, block: Optional[Block] = None
) -> torch.Tensor:
    """Forward-difference normals (normal_filter_kernel). Returns (..., 3,
    H, W) for (..., H, W) maps; ``block`` as in :func:`dilation_fill` (the
    neighbours at +1 column and +1 row never wrap to a usable cell)."""
    h, w = map2d.shape[-2:]
    block = Block.whole(h, w) if block is None else block
    hx = F.pad(map2d[..., :, 1:], (0, 1))
    hy = F.pad(map2d[..., 1:, :], (0, 0, 0, 1))
    ok = (mask > 0.5) & _normals_ok(block, map2d.device)
    dzdx = hx - map2d
    dzdy = hy - map2d
    nx = -dzdy / resolution
    ny = -dzdx / resolution
    norm = torch.sqrt(nx * nx + ny * ny + 1.0)
    out = torch.stack([nx / norm, ny / norm, 1.0 / norm], dim=-3)
    return torch.where(ok[..., None, :, :], out, 0.0)


@functools.lru_cache(maxsize=64)
def _normals_ok(block: Block, device: torch.device) -> torch.Tensor:
    """(h, w) bool: the cells whose neighbours at +1 column and +1 row are
    both usable (``_neighbor_ok``); built once per block and device, not on
    every update."""
    return _neighbor_ok(block, 0, 1, device) & _neighbor_ok(block, 1, 0, device)


@functools.lru_cache(maxsize=16)
def _neighbor_table(h: int, w: int, size: int, device: torch.device) -> torch.Tensor:
    """(k*k, h*w) flat indices of every cell's neighbours at the offsets
    w*dy + dx, dy and dx in [-size, size], with ``_neighbor_ok``'s rules.
    Unusable entries point at h*w, one past the grid, where the caller puts
    its neutral value."""
    i = torch.arange(h * w, device=device).reshape(h, w)
    block = Block.whole(h, w)
    rows = []
    for dy in range(-size, size + 1):
        for dx in range(-size, size + 1):
            j = torch.clamp(i + (w * dy + dx), 0, h * w - 1)
            rows.append(torch.where(_neighbor_ok(block, dy, dx, device), j, h * w).reshape(-1))
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
    h, w = map2d.shape
    fm = map2d.reshape(-1)
    fmask = mask.reshape(-1)
    init = tracing.upload([math.inf if mode == "min" else -math.inf], fm.device, fm.dtype)
    table = _neighbor_table(h, w, size, fm.device)
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
    return out.reshape(h, w)


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
