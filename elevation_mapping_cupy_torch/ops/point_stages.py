"""D4 ``points_associate`` and D5 ``points_fuse``: the update's per-point
chain, each one pass over the points of a batch of maps.

The chain of a whole-map update (``core.update_batch_aux`` without a
shard), from a cloud to K1's two launches: :func:`associate` transforms,
bins and classifies the points, reads their cells and counts the drift
compensation's inliers; :func:`fuse` turns the drift-compensated cells into
the Kalman proposals. On the card each is one launch of
``csrc/point_stages.cu`` (its source note gives the design, the rounding
and the bound); on the CPU each is its plain version, the ops of
``geometry.associate_points`` and ``pointcloud`` that a sharded update
still runs, which the tests hold to the JAX package and the kernels to on
the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..config import MapConfig
from ..kernels import CudaKernel, on_card
from . import pointcloud as pc
from .geometry import PointAssociation, associate_points

__all__ = [
    "ASSOCIATE_KERNEL",
    "FUSE_KERNEL",
    "Associated",
    "associate",
    "launch_associate",
    "fuse",
    "launch_fuse",
]

ASSOCIATE_KERNEL = CudaKernel(
    "point_stages.cu",
    "points_associate",
    [ctypes.c_void_p] * 17 + [ctypes.c_int64] * 2 + [ctypes.c_int32] * 3
    + [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p],
)
FUSE_KERNEL = CudaKernel(
    "point_stages.cu",
    "points_fuse",
    [ctypes.c_void_p] * 9 + [ctypes.c_int64] + [ctypes.c_int32] * 3
    + [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p],
)
# points a block of the associate kernel takes: one partial error sum each
_BLOCK_POINTS = 256


class Associated(NamedTuple):
    """What :func:`associate` hands on, for B maps of N points."""

    assoc: PointAssociation  # the association, (B, N, ...) fields
    rows: torch.Tensor       # (B, N, 2) each point's cell height and variance, before the drift
    counted: torch.Tensor    # (B, 2, N) float32 error counting's K1 streams: [inlier, mask]
    error_sum: torch.Tensor  # (B,) sum of z - cell height over the inliers
    error_cnt: torch.Tensor  # (B,) int64 number of inliers


def _kernel_constants(cfg: MapConfig) -> tuple:
    """The Python scalars that the plain versions hand to torch ops, which
    cast them to float32, in the order of the kernels' ``Const``."""
    return (
        cfg.resolution, 0.5 * cfg.cell_n, cfg.cell_n - 1, cfg.sensor_noise_factor, cfg.ramped_height_range_b,
        cfg.min_valid_distance**2, cfg.ramped_height_range_a, cfg.ramped_height_range_c, cfg.max_height_range,
        0.5, cfg.mahalanobis_thresh, cfg.drift_compensation_variance_inlier / 2.0, cfg.traversability_inlier,
        cfg.wall_num_thresh, 1e-12,
    )


def _consts(cfg: MapConfig):
    consts = _kernel_constants(cfg)
    return (ctypes.c_float * len(consts))(*consts), len(consts)


def _check_associate(points, pad_mask, R, t, layers, cfg: MapConfig) -> None:
    """Refuses shapes that neither version of the association takes."""
    if points.dim() != 3 or points.shape[-1] < 3:
        raise ValueError(f"the points must be (B, N, 3 + C); got {tuple(points.shape)}")
    b, n = points.shape[:2]
    c = cfg.cell_n
    want = {"pad_mask": (pad_mask, (b, n)), "R": (R, (b, 3, 3)), "t": (t, (b, 3)), "layers": (layers, (b, 7, c, c))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape} for these points and config; got {tuple(x.shape)}")


def associate(points, pad_mask, R, t, layers, cfg: MapConfig) -> Associated:
    """The association and the drift compensation's per-point half for B
    whole maps: ``points`` (B, N, 3 + C) sensor-frame xyz first (semantic
    channels after), ``pad_mask`` (B, N) True for real points, ``R`` (B, 3,
    3), ``t`` (B, 3) in the map-center frame, ``layers`` (B, 7, n, n).

    CUDA tensors go to the kernel (:func:`launch_associate`), one launch
    for the whole batch; CPU tensors to :func:`_associate`."""
    if on_card(layers, "the point association"):
        if points.stride(-1) != 1:
            points = points.contiguous()
        return launch_associate(points, pad_mask.contiguous(), R.contiguous(), t.contiguous(), layers.contiguous(),
                                cfg)
    return _associate(points, pad_mask, R, t, layers, cfg)


def launch_associate(points, pad_mask, R, t, layers, cfg: MapConfig) -> Associated:
    """:func:`associate` as one call of ``csrc/point_stages.cu`` on the
    current stream. Takes float32 points whose xyz are contiguous (any
    stride between points and maps), a contiguous bool ``pad_mask`` and
    contiguous float32 ``R``, ``t`` and layers; refuses anything else, and
    any tensor not on a card, before the kernel is built."""
    _check_associate(points, pad_mask, R, t, layers, cfg)
    tensors = (points, R, t, layers)
    if any(x.dtype != torch.float32 for x in tensors) or pad_mask.dtype != torch.bool:
        raise TypeError(f"the association kernel takes float32 points, R, t and layers and a bool pad_mask; "
                        f"got {[x.dtype for x in tensors]}, {pad_mask.dtype}")
    if (points.shape[1] and points.stride(-1) != 1) or not all(x.is_contiguous() for x in (pad_mask, R, t, layers)):
        raise ValueError("the association kernel needs contiguous xyz, pad_mask, R, t and layers")
    dev = points.device
    if any(x.device != dev for x in (pad_mask, R, t, layers)):
        raise ValueError("the points, pad_mask, R, t and layers must lie on one device")
    b, n = points.shape[:2]
    world = torch.empty((b, n, 3), dtype=torch.float32, device=dev)
    noise = torch.empty((b, n), dtype=torch.float32, device=dev)
    flat = torch.empty((b, n), dtype=torch.int32, device=dev)
    valid, inside, mask = (torch.empty((b, n), dtype=torch.bool, device=dev) for _ in range(3))
    counted = torch.empty((b, 2, n), dtype=torch.float32, device=dev)
    rows = torch.empty((b, n, 2), dtype=torch.float32, device=dev)
    parts = max(1, -(-n // _BLOCK_POINTS))
    part_sum = torch.empty((b, parts), dtype=torch.float64, device=dev)
    part_cnt = torch.empty((b, parts), dtype=torch.int32, device=dev)
    error_sum = torch.empty((b,), dtype=torch.float32, device=dev)
    error_cnt = torch.empty((b,), dtype=torch.int64, device=dev)
    assoc = PointAssociation(world=world, noise=noise, flat_idx=flat, valid=valid, inside=inside, mask=mask)
    out = Associated(assoc, rows, counted, error_sum, error_cnt)
    if b == 0:
        return out
    ASSOCIATE_KERNEL.launch(
        dev, points.data_ptr(), pad_mask.data_ptr(), R.data_ptr(), t.data_ptr(), layers.data_ptr(),
        world.data_ptr(), noise.data_ptr(), flat.data_ptr(), valid.data_ptr(), inside.data_ptr(), mask.data_ptr(),
        counted.data_ptr(), rows.data_ptr(), part_sum.data_ptr(), part_cnt.data_ptr(), error_sum.data_ptr(),
        error_cnt.data_ptr(), points.stride(0), points.stride(1), b, n, cfg.cell_n, *_consts(cfg),
    )
    return out


def _associate(points, pad_mask, R, t, layers, cfg: MapConfig) -> Associated:
    """Plain PyTorch version of :func:`associate`."""
    _check_associate(points, pad_mask, R, t, layers, cfg)
    assoc = associate_points(points[..., :3], pad_mask, R, t, cfg)
    cell_rows = pc.gather_cell_rows(layers, assoc.flat_idx)
    inlier = pc.drift_inliers(cell_rows, assoc, cfg)
    counted = torch.stack([inlier.to(layers.dtype), assoc.mask.to(layers.dtype)], dim=-2)
    error_sum, error_cnt = pc.error_sums(inlier, assoc.world[..., 2], cell_rows[..., 0])
    return Associated(assoc, cell_rows[..., :2], counted, error_sum, error_cnt)


def _check_fuse(stage: Associated, h_delta, point_cnt, cfg: MapConfig) -> None:
    b, n = stage.assoc.flat_idx.shape
    c = cfg.cell_n
    if tuple(h_delta.shape) != (b,) or tuple(point_cnt.shape) != (b, c, c) or tuple(stage.rows.shape) != (b, n, 2):
        raise ValueError(f"the fusion takes (B,) h_delta, (B, {c}, {c}) point counts and (B, N, 2) rows for "
                         f"(B, N) = {(b, n)}; got {tuple(h_delta.shape)}, {tuple(point_cnt.shape)}, "
                         f"{tuple(stage.rows.shape)}")


def fuse(stage: Associated, h_delta, point_cnt, cfg: MapConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fusion's per-point half for B whole maps: ``stage`` from
    :func:`associate`, ``h_delta`` (B,) the drift correction of each map's
    heights, ``point_cnt`` (B, n, n) the points in each cell (K1's first
    launch). Returns K1's streams (B, 4, N) = [fuse new_h, fuse new_v, fuse,
    outlier] and their active mask (B, N) (``pointcloud.fusion_proposals``).

    CUDA tensors go to the kernel (:func:`launch_fuse`), one launch for the
    whole batch; CPU tensors to :func:`_fuse`."""
    if on_card(point_cnt, "the point fusion"):
        return launch_fuse(stage, h_delta.contiguous(), point_cnt, cfg)
    return _fuse(stage, h_delta, point_cnt, cfg)


def launch_fuse(stage: Associated, h_delta, point_cnt, cfg: MapConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fuse` as one launch of ``csrc/point_stages.cu`` on the current
    stream. Takes what :func:`launch_associate` writes, a contiguous float32
    ``h_delta`` and float32 point counts whose maps are each contiguous;
    refuses anything else, and any tensor not on a card, before the kernel
    is built."""
    _check_fuse(stage, h_delta, point_cnt, cfg)
    a = stage.assoc
    floats = (a.world, a.noise, stage.rows, h_delta, point_cnt)
    if any(x.dtype != torch.float32 for x in floats) or a.flat_idx.dtype != torch.int32 or a.mask.dtype != torch.bool:
        raise TypeError("the fusion kernel takes float32 world, noise, rows, h_delta and point counts, int32 "
                        "indices and a bool mask")
    whole = (a.world, a.noise, a.flat_idx, a.mask, stage.rows, h_delta)
    if not all(x.is_contiguous() for x in whole) or not (point_cnt.shape[0] == 0 or point_cnt[0].is_contiguous()):
        raise ValueError("the fusion kernel needs contiguous tensors (point counts: each map)")
    dev = a.world.device
    if any(x.device != dev for x in whole + (point_cnt,)):
        raise ValueError("the association, h_delta and point counts must lie on one device")
    b, n = a.flat_idx.shape
    streams = torch.empty((b, 4, n), dtype=torch.float32, device=dev)
    active = torch.empty((b, n), dtype=torch.bool, device=dev)
    if b * n == 0:
        return streams, active
    FUSE_KERNEL.launch(
        dev, a.world.data_ptr(), a.noise.data_ptr(), a.flat_idx.data_ptr(), a.mask.data_ptr(), stage.rows.data_ptr(),
        h_delta.data_ptr(), point_cnt.data_ptr(), streams.data_ptr(), active.data_ptr(), point_cnt.stride(0), b, n,
        int(cfg.enable_edge_sharpen), *_consts(cfg),
    )
    return streams, active


def _fuse(stage: Associated, h_delta, point_cnt, cfg: MapConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fuse`."""
    _check_fuse(stage, h_delta, point_cnt, cfg)
    a = stage.assoc
    map_h = stage.rows[..., 0] + h_delta[..., None]
    pc_at = torch.gather(point_cnt.flatten(-2), -1, a.flat_idx.long())
    return pc.fusion_proposals(map_h, stage.rows[..., 1], a.world[..., 2], a.noise, a.mask, pc_at, cfg)
