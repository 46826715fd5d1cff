"""Height/variance Kalman fusion from point clouds — the hot path.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/ops/pointcloud.py``
(reference per-point CUDA kernels error_counting_kernel, add_points_kernel,
average_map_kernel and clear_overlap_map). The per-point scatters go through
``ops/scatter.py`` (kernel K1 on the card). Race resolutions R1-R4 are those
of tests/golden/reference_numpy.py, as in the JAX package.

Each function returns new tensors and leaves its inputs as they were.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import MapConfig
from . import scatter
from .geometry import PointAssociation

__all__ = [
    "ErrorCounts",
    "gather_cell_rows",
    "error_counting",
    "apply_drift_compensation",
    "point_fusion",
    "average_map",
    "clear_overlap",
]


class ErrorCounts(NamedTuple):
    inlier_cnt: torch.Tensor  # (H, W) drift-compensation inliers per cell
    point_cnt: torch.Tensor   # (H, W) valid points per cell
    error_sum: torch.Tensor   # ()  sum of (z - map_h) over inliers
    error_cnt: torch.Tensor   # ()  number of inliers (integer)


def gather_cell_rows(layers: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One row-gather of all per-cell layer values at the point cells: (N, L)."""
    return layers.reshape(layers.shape[0], -1).t()[idx.long()]


def error_counting(
    layers: torch.Tensor,
    assoc: PointAssociation,
    cfg: MapConfig,
    cell_rows: Optional[torch.Tensor] = None,
) -> ErrorCounts:
    """Count drift-compensation inliers and per-cell point totals."""
    n = cfg.cell_n
    j = assoc.flat_idx
    if cell_rows is None:
        cell_rows = gather_cell_rows(layers, j)
    map_h = cell_rows[:, 0]
    map_v = cell_rows[:, 1]
    map_valid = cell_rows[:, 2]
    map_t = cell_rows[:, 3]
    z = assoc.world[:, 2]

    inlier = (
        assoc.mask
        & (map_valid > 0.5)
        & (torch.abs(map_h - z) < map_v * cfg.mahalanobis_thresh)
        & (map_v < cfg.drift_compensation_variance_inlier / 2.0)
        & (map_t > cfg.traversability_inlier)
    )
    sums = scatter.scatter_add_streams_2d(
        n,
        n,
        j,
        [inlier.to(layers.dtype), assoc.mask.to(layers.dtype)],
        assoc.mask,
        exact=(True, True),
    )
    error_sum = torch.sum(torch.where(inlier, z - map_h, 0.0))
    error_cnt = torch.sum(inlier)
    return ErrorCounts(
        inlier_cnt=sums[0],
        point_cnt=sums[1],
        error_sum=error_sum,
        error_cnt=error_cnt,
    )


def apply_drift_compensation(
    layers: torch.Tensor,
    counts: ErrorCounts,
    position_noise: torch.Tensor,
    orientation_noise: torch.Tensor,
    mean_error_prev: torch.Tensor,
    additive_prev: torch.Tensor,
    cfg: MapConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Height drift compensation (elevation_mapping.py:346-357).

    Returns (layers, mean_error, additive_mean_error, height delta). The
    reference's host-side branch is a select on the device: nothing here
    reads a value back to the host.
    """
    if not cfg.enable_drift_compensation:
        return layers, mean_error_prev, additive_prev, torch.zeros_like(mean_error_prev)
    gate = (counts.error_cnt > cfg.min_height_drift_cnt) & (
        (position_noise > cfg.position_noise_thresh)
        | (orientation_noise > cfg.orientation_noise_thresh)
    )
    new_mean = counts.error_sum / torch.clamp(counts.error_cnt, min=1).to(layers.dtype)
    mean_error = torch.where(gate, new_mean, mean_error_prev)
    additive = torch.where(gate, additive_prev + new_mean, additive_prev)
    apply = gate & (torch.abs(new_mean) < cfg.max_drift)
    delta = torch.where(apply, new_mean * cfg.drift_compensation_alpha, 0.0).to(layers.dtype)
    layers = layers.clone()
    layers[0] += delta
    return layers, mean_error, additive, delta


def point_fusion(
    layers: torch.Tensor,
    assoc: PointAssociation,
    point_cnt: torch.Tensor,
    cfg: MapConfig,
    cell_rows: Optional[torch.Tensor] = None,
    h_delta: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point Kalman proposals + outlier handling (custom_kernels.py:160-196).

    Returns (updated layers, newmap (3, H, W) = [sum new_h, sum new_v, count]).
    ``cell_rows`` may be the pre-drift gather shared with error_counting;
    ``h_delta`` is then the drift correction to add to the height column.
    """
    n = cfg.cell_n
    flat = layers.reshape(7, -1)
    j = assoc.flat_idx
    jl = j.long()
    z = assoc.world[:, 2]
    v = assoc.noise
    if cell_rows is None:
        map_h = flat[0, jl]
        map_v = flat[1, jl]
    else:
        map_h = cell_rows[:, 0] + (h_delta if h_delta is not None else 0.0)
        map_v = cell_rows[:, 1]
    pc = point_cnt.reshape(-1)[jl]

    outlier = assoc.mask & (torch.abs(map_h - z) > map_v * cfg.mahalanobis_thresh)
    edge_skip = torch.zeros_like(outlier)
    if cfg.enable_edge_sharpen:
        edge_skip = (pc > cfg.wall_num_thresh) & (
            z < map_h - map_v * cfg.mahalanobis_thresh / torch.clamp(pc, min=1e-12)
        )
    fuse = assoc.mask & ~outlier & ~edge_skip

    new_h = (map_h * v + z * map_v) / (map_v + v)
    new_v = (map_v * v) / (map_v + v)
    # one scatter for the fused sums and the outlier count: a point is either
    # a fused inlier or an outlier, never both
    sums = scatter.scatter_add_streams_2d(
        n,
        n,
        j,
        [
            torch.where(fuse, new_h, 0.0),
            torch.where(fuse, new_v, 0.0),
            fuse.to(new_h.dtype),
            outlier.to(new_h.dtype),  # x outlier_variance applied below
        ],
        fuse | outlier,
        exact=(False, False, True, True),
    ).reshape(4, -1)
    out_var = sums[3] * cfg.outlier_variance

    sum_h, sum_v, cnt = sums[0], sums[1], sums[2]
    has = cnt > 0
    mean_h = sum_h / torch.clamp(cnt, min=1.0)

    flat = flat.clone()
    flat[1] += out_var
    flat[2] = torch.where(has, 1.0, flat[2])
    flat[4] = torch.where(has, 0.0, flat[4])
    flat[5] = torch.where(has, mean_h, flat[5])  # R2
    flat[6] = torch.where(has, 0.0, flat[6])
    newmap = torch.stack([sum_h, sum_v, cnt]).reshape(3, n, n)
    return flat.reshape(7, n, n), newmap


def average_map(layers: torch.Tensor, newmap: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """Finalize per-cell averages (custom_kernels.py:348-389)."""
    valid_pre = layers[2]
    sum_h, sum_v, cnt = newmap
    has = cnt > 0
    safe_cnt = torch.clamp(cnt, min=1.0)
    overflow = has & ((sum_v / safe_cnt) > cfg.max_variance)
    ok = has & ~overflow

    h = torch.where(ok, sum_h / safe_cnt, torch.where(overflow, 0.0, layers[0]))
    v = torch.where(ok, sum_v / safe_cnt, torch.where(overflow, cfg.initial_variance, layers[1]))
    va = torch.where(ok, 1.0, torch.where(overflow, 0.0, layers[2]))

    reset = valid_pre < 0.5
    out = layers.clone()
    out[0] = torch.where(reset, 0.0, h)
    out[1] = torch.where(reset, cfg.initial_variance, v)
    out[2] = torch.where(reset, 0.0, va)
    return out


def clear_overlap(layers: torch.Tensor, t: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """Clear cells far from the sensor height near the center
    (elevation_mapping.py:393-410)."""
    lo, hi = cfg.overlap_cell_range
    hmin = t[2] - cfg.overlap_clear_range_z
    hmax = t[2] + cfg.overlap_clear_range_z
    out = layers.clone()
    near = out[:, lo:hi, lo:hi]  # a view: the writes below land in ``out``
    ok = ~((near[0] < hmin) | (near[0] > hmax))
    near[0] = torch.where(ok, near[0], 0.0)
    near[1] = torch.where(ok, near[1], cfg.initial_variance)
    near[2] = torch.where(ok, near[2], 0.0)
    ok5 = ~((near[5] < hmin) | (near[5] > hmax))
    near[5] = torch.where(ok5, near[5], 0.0)
    near[6] = torch.where(ok5, near[6], 0.0)
    return out
