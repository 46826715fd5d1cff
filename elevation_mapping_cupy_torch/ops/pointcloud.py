"""Height/variance Kalman fusion from point clouds — the hot path.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/ops/pointcloud.py``
(reference per-point CUDA kernels error_counting_kernel, add_points_kernel,
average_map_kernel and clear_overlap_map). The per-point scatters go through
``ops/scatter.py`` (kernel K1 on the card). Race resolutions R1-R4 are those
of tests/golden/reference_numpy.py, as in the JAX package.

Each function returns new tensors and leaves its inputs as they were. Every
tensor may carry leading batch axes, one map each: layers (..., 7, H, W),
the association's fields (..., N), per-map scalars (...,). The scatters hand
all maps of a batch to one K1 launch. The layers may be a block of a larger
map (``geometry.Block``) with an association made for that block: every
stage here is per cell but the error sums and ``clear_overlap``'s window.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import MapConfig
from . import scatter
from .geometry import Block, PointAssociation

__all__ = [
    "ErrorCounts",
    "gather_cell_rows",
    "drift_inliers",
    "error_sums",
    "error_counting",
    "apply_drift_compensation",
    "fusion_proposals",
    "fusion_apply",
    "point_fusion",
    "average_map",
    "clear_overlap",
]


class ErrorCounts(NamedTuple):
    inlier_cnt: torch.Tensor  # (H, W) drift-compensation inliers per cell
    point_cnt: torch.Tensor   # (H, W) valid points per cell
    error_sum: torch.Tensor   # ()  sum of (z - map_h) over inliers
    error_cnt: torch.Tensor   # ()  number of inliers (integer)


def _gather_cells(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat (..., C) per-cell values at the (..., N) cells ``idx``."""
    return torch.gather(flat, -1, idx.long())


def gather_cell_rows(layers: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One row-gather of all per-cell layer values at the point cells:
    (..., N, L) from layers (..., L, H, W) and idx (..., N)."""
    rows = layers.flatten(-2).transpose(-1, -2)  # (..., H*W, L)
    return torch.gather(rows, -2, idx.long()[..., None].expand(*idx.shape, layers.shape[-3]))


def drift_inliers(cell_rows: torch.Tensor, assoc: PointAssociation, cfg: MapConfig) -> torch.Tensor:
    """(..., N) the points the drift compensation counts: under the mask,
    on a valid cell of low variance and high traversability, within the
    Mahalanobis band of its height. ``cell_rows`` (..., N, L) as
    :func:`gather_cell_rows` gives them."""
    map_h = cell_rows[..., 0]
    map_v = cell_rows[..., 1]
    map_valid = cell_rows[..., 2]
    map_t = cell_rows[..., 3]
    z = assoc.world[..., 2]
    return (
        assoc.mask
        & (map_valid > 0.5)
        & (torch.abs(map_h - z) < map_v * cfg.mahalanobis_thresh)
        & (map_v < cfg.drift_compensation_variance_inlier / 2.0)
        & (map_t > cfg.traversability_inlier)
    )


def error_sums(counted: torch.Tensor, z: torch.Tensor, map_h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per map, the sum of ``z - map_h`` over the ``counted`` points and
    their number (integer)."""
    return torch.sum(torch.where(counted, z - map_h, 0.0), dim=-1), torch.sum(counted, dim=-1)


def error_counting(
    layers: torch.Tensor,
    assoc: PointAssociation,
    cfg: MapConfig,
    cell_rows: Optional[torch.Tensor] = None,
    owned: Optional[torch.Tensor] = None,
) -> ErrorCounts:
    """Count drift-compensation inliers and per-cell point totals. With
    ``owned`` (..., N), the error sums count only those points (on a block,
    the points whose cell this process owns: each point once over the
    processes of a sharded map)."""
    h, w = layers.shape[-2:]
    if cell_rows is None:
        cell_rows = gather_cell_rows(layers, assoc.flat_idx)
    inlier = drift_inliers(cell_rows, assoc, cfg)
    sums = scatter.scatter_add_streams_2d(
        h,
        w,
        assoc.flat_idx,
        [inlier.to(layers.dtype), assoc.mask.to(layers.dtype)],
        assoc.mask,
    )
    counted = inlier if owned is None else inlier & owned
    error_sum, error_cnt = error_sums(counted, assoc.world[..., 2], cell_rows[..., 0])
    return ErrorCounts(
        inlier_cnt=sums[..., 0, :, :],
        point_cnt=sums[..., 1, :, :],
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

    Returns (layers, mean_error, additive_mean_error, height delta), the
    last three per map. The reference's host-side branch is a select on the
    device: nothing here reads a value back to the host.
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
    layers[..., 0, :, :] += delta[..., None, None]
    return layers, mean_error, additive, delta


def fusion_proposals(
    map_h: torch.Tensor,
    map_v: torch.Tensor,
    z: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    pc: torch.Tensor,
    cfg: MapConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point Kalman proposals and outlier decisions (custom_kernels.py:
    160-196) from each point's cell height and variance (drift-compensated),
    its height and noise, its mask and its cell's point count ``pc``, all
    (..., N). Returns K1's streams (..., 4, N) = [fuse new_h, fuse new_v,
    fuse, outlier] and their active mask fuse | outlier (a point is either a
    fused inlier or an outlier, never both)."""
    outlier = mask & (torch.abs(map_h - z) > map_v * cfg.mahalanobis_thresh)
    edge_skip = torch.zeros_like(outlier)
    if cfg.enable_edge_sharpen:
        edge_skip = (pc > cfg.wall_num_thresh) & (
            z < map_h - map_v * cfg.mahalanobis_thresh / torch.clamp(pc, min=1e-12)
        )
    fuse = mask & ~outlier & ~edge_skip

    new_h = (map_h * v + z * map_v) / (map_v + v)
    new_v = (map_v * v) / (map_v + v)
    streams = torch.stack(
        [
            torch.where(fuse, new_h, 0.0),
            torch.where(fuse, new_v, 0.0),
            fuse.to(new_h.dtype),
            outlier.to(new_h.dtype),  # x outlier_variance applied in fusion_apply
        ],
        dim=-2,
    )
    return streams, fuse | outlier


def fusion_apply(layers: torch.Tensor, sums: torch.Tensor, cfg: MapConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-cell half of the fusion: ``sums`` (..., 4, H*W) are K1's sums
    of :func:`fusion_proposals`' streams. Returns (updated layers, newmap
    (..., 3, H, W) = [sum new_h, sum new_v, count])."""
    h, w = layers.shape[-2:]
    out_var = sums[..., 3, :] * cfg.outlier_variance

    sum_h, cnt = sums[..., 0, :], sums[..., 2, :]
    has = cnt > 0
    mean_h = sum_h / torch.clamp(cnt, min=1.0)

    flat = layers.flatten(-2).clone()  # (..., 7, H*W)
    flat[..., 1, :] += out_var
    flat[..., 2, :] = torch.where(has, 1.0, flat[..., 2, :])
    flat[..., 4, :] = torch.where(has, 0.0, flat[..., 4, :])
    flat[..., 5, :] = torch.where(has, mean_h, flat[..., 5, :])  # R2
    flat[..., 6, :] = torch.where(has, 0.0, flat[..., 6, :])
    newmap = sums[..., :3, :].reshape(*sums.shape[:-2], 3, h, w)
    return flat.reshape(layers.shape), newmap


def point_fusion(
    layers: torch.Tensor,
    assoc: PointAssociation,
    point_cnt: torch.Tensor,
    cfg: MapConfig,
    cell_rows: Optional[torch.Tensor] = None,
    h_delta: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point Kalman proposals + outlier handling (custom_kernels.py:160-196).

    Returns (updated layers, newmap (..., 3, H, W) = [sum new_h, sum new_v,
    count]). ``cell_rows`` may be the pre-drift gather shared with
    error_counting; ``h_delta`` (per map) is then the drift correction to
    add to the height column.
    """
    h, w = layers.shape[-2:]
    flat = layers.flatten(-2)  # (..., 7, H*W)
    j = assoc.flat_idx
    if cell_rows is None:
        map_h = _gather_cells(flat[..., 0, :], j)
        map_v = _gather_cells(flat[..., 1, :], j)
    else:
        map_h = cell_rows[..., 0] + (h_delta[..., None] if h_delta is not None else 0.0)
        map_v = cell_rows[..., 1]
    pc = _gather_cells(point_cnt.flatten(-2), j)
    streams, active = fusion_proposals(map_h, map_v, assoc.world[..., 2], assoc.noise, assoc.mask, pc, cfg)
    return fusion_apply(layers, scatter.scatter_add_multi(h * w, j, streams, active), cfg)


def average_map(layers: torch.Tensor, newmap: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """Finalize per-cell averages (custom_kernels.py:348-389)."""
    valid_pre = layers[..., 2, :, :]
    sum_h, sum_v, cnt = newmap.unbind(-3)
    has = cnt > 0
    safe_cnt = torch.clamp(cnt, min=1.0)
    overflow = has & ((sum_v / safe_cnt) > cfg.max_variance)
    ok = has & ~overflow

    h = torch.where(ok, sum_h / safe_cnt, torch.where(overflow, 0.0, layers[..., 0, :, :]))
    v = torch.where(ok, sum_v / safe_cnt, torch.where(overflow, cfg.initial_variance, layers[..., 1, :, :]))
    va = torch.where(ok, 1.0, torch.where(overflow, 0.0, layers[..., 2, :, :]))

    reset = valid_pre < 0.5
    out = layers.clone()
    out[..., 0, :, :] = torch.where(reset, 0.0, h)
    out[..., 1, :, :] = torch.where(reset, cfg.initial_variance, v)
    out[..., 2, :, :] = torch.where(reset, 0.0, va)
    return out


def clear_overlap(layers: torch.Tensor, t: torch.Tensor, cfg: MapConfig, block: Optional[Block] = None) -> torch.Tensor:
    """Clear cells far from the sensor height near the center
    (elevation_mapping.py:393-410). t (..., 3). The window is the map's
    ``[lo, hi)`` square, met with ``block`` when the layers are one."""
    lo, hi = cfg.overlap_cell_range
    r = slice(lo, hi)
    c = slice(lo, hi)
    if block is not None:
        r = slice(max(lo - block.r0, 0), max(min(hi - block.r0, block.h), 0))
        c = slice(max(lo - block.c0, 0), max(min(hi - block.c0, block.w), 0))
    tz = t[..., 2, None, None]
    hmin = tz - cfg.overlap_clear_range_z
    hmax = tz + cfg.overlap_clear_range_z
    out = layers.clone()
    near = out[..., r, c]  # a view: the writes below land in ``out``
    ok = ~((near[..., 0, :, :] < hmin) | (near[..., 0, :, :] > hmax))
    near[..., 0, :, :] = torch.where(ok, near[..., 0, :, :], 0.0)
    near[..., 1, :, :] = torch.where(ok, near[..., 1, :, :], cfg.initial_variance)
    near[..., 2, :, :] = torch.where(ok, near[..., 2, :, :], 0.0)
    ok5 = ~((near[..., 5, :, :] < hmin) | (near[..., 5, :, :] > hmax))
    near[..., 5, :, :] = torch.where(ok5, near[..., 5, :, :], 0.0)
    near[..., 6, :, :] = torch.where(ok5, near[..., 6, :, :], 0.0)
    return out
