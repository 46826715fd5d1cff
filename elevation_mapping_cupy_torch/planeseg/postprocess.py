"""Plane-decomposition postprocessing — full parity with the reference
Postprocessing stage (plane_segmentation/convex_plane_decomposition/src/
Postprocessing.cpp:14-31, 33-71, 73-144).

PyTorch counterpart of ``elevation_mapping_cupy_tpu/planeseg/postprocess.py``:

  * ``addHeightOffset`` on planar regions (world-z shift of each plane frame)
  * ``addSmoothLayer``: non-planar cells → NaN → min-values inpaint →
    morphological close (ellipse, BORDER_REPLICATE) → 45-degree-slope cone
    dilation (applyKernelFunction with a sqrt(dx²+dy²)·res offset stack) →
    normalized box blur → Gaussian blur
  * ``dilationInNonplanarRegions``: ellipse dilation merged into non-planar
    cells only
  * ``addHeightOffset`` on the elevation layer (planar/non-planar offsets)

OpenCV-matching details reproduced here: cv::getStructuringElement
MORPH_ELLIPSE footprints, BORDER_REPLICATE padding for the centred
morphology/blur operators, the grid_map_filters_rsl *shifted-window* border
rule for the cone dilation, and cv::GaussianBlur's fixed small-kernel tap
tables for sigma<=0 (OpenCV getGaussianKernel).

The footprints and tap tables are built on the host; the filters take
(..., H, W) maps on any device, leading axes a batch. The morphology stacks
its taps and takes one ``amax``/``amin`` (order-free, so exact); the box and
Gaussian sums run in the JAX package's order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..ops.geometry import true_div
from ..ops.gridmap_filters import _pad_edge, inpaint_min_values, shifted_window_stack

__all__ = [
    "PostprocessingParams",
    "ellipse_kernel",
    "kernel_size_in_pixels",
    "gaussian_kernel_cv",
    "add_smooth_layer",
    "postprocess",
]


@dataclasses.dataclass(frozen=True)
class PostprocessingParams:
    """Mirrors PostprocessingParameters (Postprocessing.h:7-25); defaults are
    the reference header defaults == the deployed parameters.yaml values."""

    extracted_planes_height_offset: float = 0.0
    nonplanar_height_offset: float = 0.02
    nonplanar_horizontal_offset: int = 1       # pixels
    smoothing_dilation_size: float = 0.2       # [m], half-width
    smoothing_box_kernel_size: float = 0.1     # [m], half-width
    smoothing_gauss_kernel_size: float = 0.05  # [m], half-width


def _cv_round(x: float) -> int:
    """cvRound: round half to even (OpenCV saturate_cast<int>(double))."""
    return int(np.rint(x))


def kernel_size_in_pixels(real_size: float, resolution: float) -> int:
    """2*round(size/res)+1 (Postprocessing.cpp:75-77; std::round = half away
    from zero for positive args)."""
    return 2 * int(math.floor(real_size / resolution + 0.5)) + 1


def ellipse_kernel(size: int) -> np.ndarray:
    """cv::getStructuringElement(MORPH_ELLIPSE, (size, size)) — the inscribed
    ellipse footprint OpenCV rasterizes row by row."""
    r = size // 2
    c = size // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    ker = np.zeros((size, size), bool)
    for i in range(size):
        dy = i - r
        if abs(dy) <= r:
            dx = _cv_round(c * math.sqrt(max(r * r - dy * dy, 0) * inv_r2))
            ker[i, max(c - dx, 0) : min(c + dx + 1, size)] = True
        # rows with |dy| > r stay empty (only possible for even sizes)
    return ker


def _morph_footprint(h: torch.Tensor, footprint: np.ndarray, maximum: bool) -> torch.Tensor:
    """Centred morphology with an arbitrary footprint, BORDER_REPLICATE
    (cv::dilate/cv::erode semantics; finite input assumed, a NaN spreads as
    in the JAX package's ``jnp.maximum`` chain)."""
    size = footprint.shape[0]
    pad = size // 2
    H, W = h.shape[-2:]
    p = _pad_edge(h, pad, pad, pad, pad)
    taps = torch.stack(
        [p[..., dy : dy + H, dx : dx + W] for dy in range(size) for dx in range(size) if footprint[dy, dx]]
    )
    return torch.amax(taps, dim=0) if maximum else torch.amin(taps, dim=0)


def _morph_close(h: torch.Tensor, footprint: np.ndarray) -> torch.Tensor:
    """cv::morphologyEx MORPH_CLOSE = dilate then erode (Postprocessing.cpp:108-111)."""
    return _morph_footprint(_morph_footprint(h, footprint, True), footprint, False)


def _cone_dilate(h: torch.Tensor, size: int, resolution: float) -> torch.Tensor:
    """45-degree-slope dilation: max over finites of (window - slope*dist)
    with slope = resolution per pixel (Postprocessing.cpp:115-128). Uses the
    applyKernelFunction shifted-window border rule, including its quirk that
    the offset stack stays anchored to the (shifted) window near borders."""
    half = (size - 1) // 2
    offs = np.empty((size * size,), np.float32)
    for i in range(size):
        for j in range(size):
            offs[i * size + j] = resolution * math.sqrt(
                (i - half) ** 2 + (j - half) ** 2
            )
    stack = shifted_window_stack(h, size) - torch.from_numpy(offs).to(h.device)[:, None, None]
    mx = torch.amax(torch.where(torch.isfinite(stack), stack, -math.inf), dim=-3)
    return torch.where(torch.isinf(mx), math.nan, mx)


# OpenCV getGaussianKernel fixed taps for ksize<=7, sigma<=0
_SMALL_GAUSSIAN_TAB = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def gaussian_kernel_cv(size: int, sigma: float = 0.0) -> np.ndarray:
    """cv::getGaussianKernel: fixed small-kernel taps when sigma<=0 and
    ksize<=7; otherwise exp taps with OpenCV's derived sigma."""
    if sigma <= 0 and size <= 7 and size % 2 == 1:
        return np.asarray(_SMALL_GAUSSIAN_TAB[size], np.float64)
    s = sigma if sigma > 0 else 0.3 * ((size - 1) * 0.5 - 1) + 0.8
    x = np.arange(size, dtype=np.float64) - (size - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * s * s))
    return k / k.sum()


def _box_filter(h: torch.Tensor, size: int) -> torch.Tensor:
    """cv::boxFilter normalize=true, BORDER_REPLICATE (Postprocessing.cpp:136)."""
    pad = size // 2
    H, W = h.shape[-2:]
    p = _pad_edge(h, pad, pad, pad, pad)
    acc = torch.zeros_like(h)
    for dy in range(size):
        for dx in range(size):
            acc = acc + p[..., dy : dy + H, dx : dx + W]
    return true_div(acc, float(size * size))


def _gaussian_blur(h: torch.Tensor, size: int, sigma: float = 0.0) -> torch.Tensor:
    """cv::GaussianBlur, BORDER_REPLICATE, separable (Postprocessing.cpp:137)."""
    k = gaussian_kernel_cv(size, sigma)
    pad = size // 2
    H, W = h.shape[-2:]
    pr = _pad_edge(h, pad, pad, 0, 0)
    h = sum(float(k[i]) * pr[..., i : i + H, :] for i in range(size))
    pc = _pad_edge(h, 0, 0, pad, pad)
    return sum(float(k[i]) * pc[..., :, i : i + W] for i in range(size))


def add_smooth_layer(
    elevation: torch.Tensor,       # (..., H, W), finite (preprocessed)
    planarity_mask: torch.Tensor,  # (..., H, W), 1.0 = planar, 0.0 = non-planar
    resolution: float,
    params: PostprocessingParams = PostprocessingParams(),
) -> torch.Tensor:
    """smooth_planar layer (Postprocessing.cpp:73-144): NaN-out non-planar →
    minValues inpaint → ellipse close → 45-degree cone dilation → box+Gauss."""
    dilation_size = kernel_size_in_pixels(params.smoothing_dilation_size, resolution)
    kernel = kernel_size_in_pixels(params.smoothing_box_kernel_size, resolution)
    kernel_gauss = kernel_size_in_pixels(params.smoothing_gauss_kernel_size, resolution)

    with_nan = torch.where(planarity_mask == 1.0, elevation, math.nan)
    inpainted = inpaint_min_values(with_nan)
    closed = _morph_close(inpainted, ellipse_kernel(dilation_size))
    dilated = _cone_dilate(closed, dilation_size, resolution)
    return _gaussian_blur(_box_filter(dilated, kernel), kernel_gauss)


def postprocess(
    elevation: torch.Tensor,
    planarity_mask: torch.Tensor,
    resolution: float,
    params: PostprocessingParams = PostprocessingParams(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full Postprocessing::postprocess on the elevation layer
    (Postprocessing.cpp:14-31). Returns (elevation_out, smooth_planar);
    the smooth layer is computed from the UN-dilated, un-offset elevation
    like the reference (smooth layer is added before the in-place edits).
    Region height offsets are applied host-side by the pipeline."""
    smooth = add_smooth_layer(elevation, planarity_mask, resolution, params)

    # dilationInNonplanarRegions (Postprocessing.cpp:33-52)
    out = elevation
    if params.nonplanar_horizontal_offset > 0:
        size = 2 * params.nonplanar_horizontal_offset + 1
        dilated = _morph_footprint(out, ellipse_kernel(size), True)
        out = planarity_mask * out + (1.0 - planarity_mask) * dilated

    # addHeightOffset (Postprocessing.cpp:54-63)
    if params.extracted_planes_height_offset != 0.0 or params.nonplanar_height_offset != 0.0:
        out = out + (params.extracted_planes_height_offset + params.nonplanar_height_offset)
        if params.nonplanar_height_offset != 0.0:
            out = out - params.nonplanar_height_offset * planarity_mask

    return out, smooth
