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

import torch

from ..kernels import CudaKernel

__all__ = ["KERNEL", "scatter_add_streams", "scatter_add_streams_reference"]

KERNEL = CudaKernel(
    "scatter_add.cu",
    "scatter_add_streams",
    [ctypes.c_void_p] * 4
    + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p],
)


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
    if values.device.type == "cpu":
        return scatter_add_streams_reference(idx, mask, values, n_cells)
    if values.device.type != "cuda":
        raise ValueError(f"scatter_add_streams runs on cuda or cpu tensors, not {values.device}")
    if not (idx.is_contiguous() and mask.is_contiguous() and values.is_contiguous()):
        raise ValueError("scatter_add_streams needs contiguous tensors")
    b, k, n = values.shape
    out = torch.zeros((b, k, n_cells), dtype=torch.float32, device=values.device)
    if b * n == 0 or k == 0:
        return out
    with torch.cuda.device(values.device):
        KERNEL.launch(
            idx.data_ptr(), mask.data_ptr(), values.data_ptr(), out.data_ptr(),
            b, n, k, n_cells, torch.cuda.current_stream().cuda_stream,
        )
    return out
