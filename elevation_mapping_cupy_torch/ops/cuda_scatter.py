"""K1 ``scatter_add_streams``: the point->cell scatter-add of K streams.

Counterpart of ``elevation_mapping_cupy_tpu/ops/pallas_scatter.py`` (the
MXU matmul-scatter ``_kernel``). The CUDA kernel is ``csrc/scatter_add.cu``;
its source note gives the design and the bound. :func:`scatter_add_streams`
launches it for a CUDA tensor and raises if it cannot; for a CPU tensor it
runs :func:`scatter_add_streams_reference`, the plain PyTorch version, which
the tests compare with the JAX kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..kernels import CudaKernel, on_card

__all__ = ["KERNEL", "LaunchPlan", "launch_plan", "scatter_add_streams", "scatter_add_streams_reference"]

KERNEL = CudaKernel(
    "scatter_add.cu",
    "scatter_add_streams",
    [ctypes.c_void_p] * 4
    + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
       ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p],
)

# dynamic shared memory one block can opt into on Hopper (227 KB)
MAX_SHARED_BYTES = 232448
# streaming multiprocessors of an H100: the private path, one block an SM at
# the deployed map size, cuts the points into as many slices as fill them
SM_COUNT = 132
# fewest points worth a slice of their own: a block zeroes and scans a whole
# map tile whatever its slice holds
MIN_SLICE_POINTS = 1024
PRIVATE_THREADS = 1024
GLOBAL_THREADS = 256


class LaunchPlan(NamedTuple):
    """How K1 runs one shape (csrc/scatter_add.cu): on the ``private`` path
    ``slices`` x K x B blocks of ``threads`` threads, each with a tile of
    ``shared_bytes`` in shared memory and ``slices`` slices of the points
    per (batch, stream); on the ``global`` path one thread per (batch,
    point) and no shared memory."""

    path: str
    slices: int
    threads: int
    shared_bytes: int
    blocks: int


def launch_plan(b: int, k: int, n: int, n_cells: int) -> LaunchPlan:
    """The path K1 takes for idx (b, n), values (b, k, n) and ``n_cells``
    cells, from the shape alone: ``private`` when one stream's float32 map
    fits in a block's shared memory, else ``global``. A private launch fills
    at most ``max(SM_COUNT, k * b)`` blocks."""
    shared = 4 * n_cells
    if shared > MAX_SHARED_BYTES:
        return LaunchPlan("global", 0, GLOBAL_THREADS, 0, -(-b * n // GLOBAL_THREADS))
    pairs = max(b * k, 1)
    slices = max(1, min(SM_COUNT // pairs, -(-n // MIN_SLICE_POINTS)))
    return LaunchPlan("private", slices, PRIVATE_THREADS, shared, slices * k * b)


def _check(idx: torch.Tensor, mask: torch.Tensor, values: torch.Tensor) -> None:
    if idx.dim() != 2 or mask.shape != idx.shape:
        raise ValueError(f"idx and mask must be (B, N); got {tuple(idx.shape)} and {tuple(mask.shape)}")
    if values.dim() != 3 or values.shape[0] != idx.shape[0] or values.shape[2] != idx.shape[1]:
        raise ValueError(f"values must be (B, K, N) for idx {tuple(idx.shape)}; got {tuple(values.shape)}")
    if idx.dtype != torch.int32 or mask.dtype != torch.bool or values.dtype != torch.float32:
        raise TypeError(
            f"expected int32 idx, bool mask, float32 values; got {idx.dtype}, {mask.dtype}, {values.dtype}"
        )
    if not (idx.device == mask.device == values.device):
        raise ValueError("idx, mask and values must lie on one device")


def scatter_add_streams_reference(
    idx: torch.Tensor, mask: torch.Tensor, values: torch.Tensor, n_cells: int
) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` on the flat (B*K*n_cells,) buffer.

    idx (B, N) int32, mask (B, N) bool, values (B, K, N) float32 ->
    (B, K, n_cells) float32. Masked points and indices outside
    [0, n_cells) add nothing."""
    _check(idx, mask, values)
    b, k, n = values.shape
    keep = mask & (idx >= 0) & (idx < n_cells)
    safe = torch.where(keep, idx, 0).to(torch.int64)
    base = (torch.arange(b * k, device=idx.device) * n_cells).view(b, k, 1)
    flat_idx = (base + safe[:, None, :]).reshape(-1)
    flat_val = torch.where(keep[:, None, :], values, 0.0).reshape(-1)
    out = torch.zeros(b * k * n_cells, dtype=torch.float32, device=values.device)
    out.index_add_(0, flat_idx, flat_val)
    return out.view(b, k, n_cells)


def scatter_add_streams(
    idx: torch.Tensor, mask: torch.Tensor, values: torch.Tensor, n_cells: int
) -> torch.Tensor:
    """Scatter-add K streams into flat cells: see
    :func:`scatter_add_streams_reference` for the contract. A CUDA tensor
    goes to the kernel; a CPU tensor to the plain version."""
    _check(idx, mask, values)
    if not on_card(values, "scatter_add_streams"):
        return scatter_add_streams_reference(idx, mask, values, n_cells)
    if not (idx.is_contiguous() and mask.is_contiguous() and values.is_contiguous()):
        raise ValueError("scatter_add_streams needs contiguous tensors")
    b, k, n = values.shape
    if b * n == 0 or k == 0 or n_cells == 0:
        return torch.zeros((b, k, n_cells), dtype=torch.float32, device=values.device)
    plan = launch_plan(b, k, n, n_cells)
    # the entry point zeroes the output on the stream before it adds
    out = torch.empty((b, k, n_cells), dtype=torch.float32, device=values.device)
    KERNEL.launch(
        values.device, idx.data_ptr(), mask.data_ptr(), values.data_ptr(), out.data_ptr(),
        b, n, k, n_cells, plan.slices, plan.shared_bytes,
    )
    return out
