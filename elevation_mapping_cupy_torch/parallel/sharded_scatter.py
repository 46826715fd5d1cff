"""Shard-local scatter for spatially sharded maps.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/parallel/sharded_scatter.py``.
The map's rows (and, over a second mesh axis, its columns) are cut over the
processes of a mesh and the points are replicated: each process keeps the
points whose cell lies in its block, rewrites their index to the block's
own, and launches K1 on the block alone. Every point lands in exactly one
cell, so this ownership binning partitions the points exactly: no process
writes another's cells and the scatter itself needs no collective.

``sharded_scatter_ctx`` routes every ``ops.scatter.scatter_add_streams_2d``
call inside it through this path, as the JAX package's ContextVar does. The
sharded update step (``spatial.py``) bins the points once, in
``geometry.associate_points`` with the step's padded block
(``Block.localize``, the same binning), since its stages also gather cell
values per point from the block.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from ..ops.geometry import Block
from .halo import mesh_axis
from .mesh import Mesh

__all__ = ["sharded_scatter_add_streams_2d", "sharded_scatter_ctx"]


def sharded_scatter_add_streams_2d(
    h: int,
    w: int,
    flat_idx: torch.Tensor,
    values: Sequence[torch.Tensor],
    mask: torch.Tensor,
    mesh: Mesh,
    axis_name: str = "x",
    col_axis_name: Optional[str] = None,
) -> torch.Tensor:
    """Scatter K per-point streams of an (h, w) grid sharded over ``mesh``;
    returns this process's block (..., K, rows, cols).

    ``ops.scatter.scatter_add_streams_2d``'s contract, but the process
    scatters only the points whose cell falls in its block, through one K1
    launch on the block. With only ``axis_name`` the grid is row-sharded;
    with ``col_axis_name`` it is tiled over a 2D mesh. Extents that do not
    divide a mesh axis are padded up (the pad cells are unreachable: indices
    are < h*w), so the last block is cut to the grid."""
    from ..ops import scatter as sc

    rows, cols = mesh_axis(mesh, axis_name), mesh_axis(mesh, col_axis_name)
    h_loc = -(-h // rows.size)
    w_loc = -(-w // cols.size)
    block = Block(rows.index * h_loc, cols.index * w_loc, h_loc, w_loc, h_loc * rows.size, w_loc * cols.size)
    local, held = block.localize(flat_idx // w, flat_idx % w)
    own = mask & held
    out = sc.scatter_add_streams_2d_local(h_loc, w_loc, torch.where(own, local, 0), values, own)
    return out[..., : max(h - block.r0, 0), : max(w - block.c0, 0)]


@contextlib.contextmanager
def sharded_scatter_ctx(mesh: Mesh, axis_name: str = "x", col_axis_name: Optional[str] = None):
    """Every ``ops.scatter.scatter_add_streams_2d`` call inside this context
    scatters onto this process's block of the mesh-sharded grid (pass
    ``col_axis_name`` for 2D tiling)."""
    from ..ops import scatter as sc

    token = sc._SPATIAL_SHARDING.set((mesh, axis_name, col_axis_name))
    try:
        yield
    finally:
        sc._SPATIAL_SHARDING.reset(token)
