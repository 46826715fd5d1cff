"""Scatter primitives for point->cell accumulation: the router.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/ops/scatter.py``. Every
scatter-add goes through :func:`cuda_scatter.scatter_add_streams`, which
dispatches on the tensors' device: the CUDA kernel K1 for a CUDA tensor
(raising if it cannot launch), the plain ``index_add_`` version for a CPU
tensor. Masked-out points contribute their neutral value at cell 0, as in
the JAX package (``scatter.py:56-59``).

Every function takes leading batch axes on its per-point tensors (the maps
of a batch, each with its own cells): the scatter-adds hand all maps to one
K1 launch, the others offset each map's indices into one ``scatter_reduce``.
Unbatched tensors are a batch of one.

Inside ``parallel.sharded_scatter.sharded_scatter_ctx`` (a ContextVar, as
the JAX package's ``_SPATIAL_SHARDING``, ``scatter.py:46``),
:func:`scatter_add_streams_2d` scatters onto this process's block of a
spatially sharded grid instead.
"""

from __future__ import annotations

import contextvars
import math
from typing import Sequence, Union

import torch

from . import cuda_scatter

__all__ = [
    "scatter_add",
    "scatter_add_multi",
    "scatter_add_streams_2d",
    "scatter_min",
    "scatter_max",
    "scatter_or",
    "smallest_unique",
]


# (mesh, axis_name, col_axis_name) set by
# parallel.sharded_scatter.sharded_scatter_ctx: scatter_add_streams_2d calls
# in the same context route to the shard-local scatter
_SPATIAL_SHARDING: contextvars.ContextVar = contextvars.ContextVar("elev_spatial_sharding", default=None)


def _masked(idx: torch.Tensor, values: torch.Tensor, mask: torch.Tensor, neutral):
    safe_idx = torch.where(mask, idx, 0)
    safe_val = torch.where(mask, values, neutral)
    return safe_idx, safe_val


def scatter_add_multi(
    n_cells: int, idx: torch.Tensor, values: Union[Sequence[torch.Tensor], torch.Tensor], mask: torch.Tensor
) -> torch.Tensor:
    """Scatter several per-point value streams with one shared index set, in
    one kernel launch. ``idx``, ``mask`` and each value stream are (..., N),
    the K streams given as a sequence or already stacked, (..., K, N);
    returns (..., K, n_cells) float32, the leading axes a batch of maps that
    K1 takes in the same launch. The kernel skips masked points, so their
    index and values are never read."""
    lead = idx.shape[:-1]
    n = idx.shape[-1]
    if isinstance(values, torch.Tensor):
        vals = values.to(torch.float32)
    else:
        vals = torch.stack([v.to(torch.float32) for v in values], dim=-2)  # (..., K, N)
    k = vals.shape[-2]
    out = cuda_scatter.scatter_add_streams(
        idx.to(torch.int32).reshape(-1, n).contiguous(),
        mask.reshape(-1, n).contiguous(),
        vals.reshape(-1, k, n),
        n_cells,
    )
    return out.reshape(*lead, k, n_cells)


def scatter_add(n_cells: int, idx: torch.Tensor, values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum_i values[i] into flat cells; returns (..., n_cells)."""
    return scatter_add_multi(n_cells, idx, [values], mask)[..., 0, :]


def scatter_add_streams_2d(
    h: int,
    w: int,
    flat_idx: torch.Tensor,
    values: Union[Sequence[torch.Tensor], torch.Tensor],
    mask: torch.Tensor,
) -> torch.Tensor:
    """Scatter K per-point streams (a sequence, or stacked (..., K, N)) into
    an (h, w) grid; returns (..., K, h, w).

    K1 adds every stream in float32 (integer streams exactly below 2^24),
    so unlike the JAX package's MXU kernel it takes no ``exact`` flags.

    Under an active ``sharded_scatter_ctx`` the call is dispatched
    shard-locally: this process scatters the points it owns onto its own
    block of the grid and returns that block
    (``parallel/sharded_scatter.py``)."""
    sharding = _SPATIAL_SHARDING.get()
    if sharding is not None:
        from ..parallel.sharded_scatter import sharded_scatter_add_streams_2d

        return sharded_scatter_add_streams_2d(h, w, flat_idx, values, mask, *sharding)
    return scatter_add_streams_2d_local(h, w, flat_idx, values, mask)


def scatter_add_streams_2d_local(
    h: int,
    w: int,
    flat_idx: torch.Tensor,
    values: Union[Sequence[torch.Tensor], torch.Tensor],
    mask: torch.Tensor,
) -> torch.Tensor:
    """The body of :func:`scatter_add_streams_2d` on one process's grid
    (the whole grid, or a block of a sharded one): one K1 launch."""
    out = scatter_add_multi(h * w, flat_idx, values, mask)
    return out.reshape(*out.shape[:-1], h, w)


def _scatter_reduce(
    n_cells: int, idx: torch.Tensor, values: torch.Tensor, mask: torch.Tensor, init, reduce: str
) -> torch.Tensor:
    """``scatter_reduce`` of (..., N) points into (..., n_cells): with
    leading axes, map b's indices are offset by b * n_cells into one flat
    reduction."""
    safe_idx, safe_val = _masked(idx, values, mask, init)
    lead = idx.shape[:-1]
    b = math.prod(lead)
    flat_idx = safe_idx.to(torch.int64)
    if b > 1:
        flat_idx = flat_idx + torch.arange(b, device=idx.device).view(*lead, 1) * n_cells
    out = torch.full((b * n_cells,), init, dtype=values.dtype, device=values.device)
    out = out.scatter_reduce(0, flat_idx.reshape(-1), safe_val.reshape(-1), reduce=reduce, include_self=True)
    return out.reshape(*lead, n_cells)


def scatter_min(
    n_cells: int, idx: torch.Tensor, values: torch.Tensor, mask: torch.Tensor, init: float
) -> torch.Tensor:
    """Per-cell minimum. An XLA scatter in the JAX package, not a Pallas
    kernel, so PyTorch's ``scatter_reduce`` serves on every device."""
    return _scatter_reduce(n_cells, idx, values, mask, init, "amin")


def scatter_max(
    n_cells: int, idx: torch.Tensor, values: torch.Tensor, mask: torch.Tensor, init: float
) -> torch.Tensor:
    """Per-cell maximum; like :func:`scatter_min`, an XLA scatter in the JAX
    package (``ops/scatter.py:167-169``) and ``scatter_reduce`` here."""
    return _scatter_reduce(n_cells, idx, values, mask, init, "amax")


def scatter_or(n_cells: int, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Boolean "any point landed here" per cell (``ops/scatter.py:172-174``
    of the JAX package: a :func:`scatter_max` of the mask)."""
    return scatter_max(n_cells, idx, mask.to(torch.float32), mask, 0.0) > 0.5


def smallest_unique(cand: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """The ``size`` smallest distinct values along the last axis of the
    integer tensor ``cand``, in ascending order, padded with ``fill`` (which
    must not be smaller than any value): what ``jnp.unique(row, size=size,
    fill_value=fill)`` returns for each row. Leading axes are a batch. Static
    shapes throughout (sort, rank by ``cumsum``, ``scatter_reduce(amin)``),
    so nothing is read back to the host."""
    s, _ = torch.sort(cand, dim=-1)
    first = torch.ones_like(s, dtype=torch.bool)
    first[..., 1:] = s[..., 1:] != s[..., :-1]
    # rank of each element's value among the distinct values; equal values
    # share a rank, so amin over a rank's elements is that value
    rank = torch.clamp(torch.cumsum(first, -1) - 1, max=size)
    out = torch.full((*cand.shape[:-1], size + 1), fill, dtype=cand.dtype, device=cand.device)
    return out.scatter_reduce(-1, rank, s, reduce="amin", include_self=True)[..., :size]
