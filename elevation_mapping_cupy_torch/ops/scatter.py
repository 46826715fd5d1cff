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
