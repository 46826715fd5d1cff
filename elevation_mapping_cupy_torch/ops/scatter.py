"""Scatter primitives for point->cell accumulation: the router.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/ops/scatter.py``. Every
scatter-add goes through :func:`cuda_scatter.scatter_add_streams`, which
dispatches on the tensors' device: the CUDA kernel K1 for a CUDA tensor
(raising if it cannot launch), the plain ``index_add_`` version for a CPU
tensor. Masked-out points contribute their neutral value at cell 0, as in
the JAX package (``scatter.py:56-59``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

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


def _masked(idx: torch.Tensor, values: torch.Tensor, mask: torch.Tensor, neutral):
    safe_idx = torch.where(mask, idx, 0)
    safe_val = torch.where(mask, values, neutral)
    return safe_idx, safe_val


def scatter_add_multi(
    n_cells: int, idx: torch.Tensor, values: Sequence[torch.Tensor], mask: torch.Tensor
) -> torch.Tensor:
    """Scatter several per-point value streams with one shared index set, in
    one kernel launch. Returns (K, n_cells) float32. The kernel skips masked
    points, so their index and values are never read."""
    vals = torch.stack([v.to(torch.float32) for v in values])  # (K, N)
    return cuda_scatter.scatter_add_streams(
        idx.to(torch.int32)[None].contiguous(), mask[None].contiguous(), vals[None], n_cells
    )[0]


def scatter_add(n_cells: int, idx: torch.Tensor, values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum_i values[i] into flat cells; returns (n_cells,)."""
    return scatter_add_multi(n_cells, idx, [values], mask)[0]


def scatter_add_streams_2d(
    h: int,
    w: int,
    flat_idx: torch.Tensor,
    values: Sequence[torch.Tensor],
    mask: torch.Tensor,
    exact: Tuple[bool, ...],
) -> torch.Tensor:
    """Scatter K per-point streams into an (h, w) grid; returns (K, h, w).

    ``exact[k]`` marks streams whose values are integers (flags, counts).
    The JAX package's MXU kernel needs it to split the other streams into
    bf16 parts; the atomic kernel adds every stream in float32 and keeps it
    only for the same signature (integer streams sum exactly below 2^24)."""
    if len(exact) != len(values):
        raise ValueError(f"exact names {len(exact)} streams, values has {len(values)}")
    return scatter_add_multi(h * w, flat_idx, values, mask).reshape(-1, h, w)


def scatter_min(
    n_cells: int, idx: torch.Tensor, values: torch.Tensor, mask: torch.Tensor, init: float
) -> torch.Tensor:
    """Per-cell minimum. An XLA scatter in the JAX package, not a Pallas
    kernel, so PyTorch's ``scatter_reduce`` serves on every device."""
    safe_idx, safe_val = _masked(idx, values, mask, init)
    out = torch.full((n_cells,), init, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, safe_idx.to(torch.int64), safe_val, reduce="amin", include_self=True)


def scatter_max(
    n_cells: int, idx: torch.Tensor, values: torch.Tensor, mask: torch.Tensor, init: float
) -> torch.Tensor:
    """Per-cell maximum; like :func:`scatter_min`, an XLA scatter in the JAX
    package (``ops/scatter.py:167-169``) and ``scatter_reduce`` here."""
    safe_idx, safe_val = _masked(idx, values, mask, init)
    out = torch.full((n_cells,), init, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, safe_idx.to(torch.int64), safe_val, reduce="amax", include_self=True)


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
