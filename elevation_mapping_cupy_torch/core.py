"""Functional core: one geometric map update and the map maintenance steps.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/core.py`` without the
semantic and image paths (later slices). Every function takes a
``MapState`` and returns a new one; the input state's tensors are not
written. The state's device decides where the work runs: on a CUDA state
the scatters launch kernel K1, on a CPU state they take its plain version.
"""

from __future__ import annotations

from typing import Union

import torch

from .config import MapConfig
from .nn.traversability import TravFilter
from .ops import pointcloud as pc
from .ops import raycast as rc
from .ops import stencil
from .ops.geometry import associate_points, true_div
from .state import MapState

__all__ = [
    "update_pointcloud",
    "move_to",
    "move",
    "shift_map_xy",
    "shift_map_z",
    "update_variance",
    "update_time",
    "update_upper_bound_with_valid_elevation",
    "clear",
    "update_normal",
]

Scalar = Union[float, torch.Tensor]


# ---------------------------------------------------------------------------
# pointcloud update (hot path)
# ---------------------------------------------------------------------------

@torch.no_grad()
def update_pointcloud(
    state: MapState,
    points: torch.Tensor,       # (N, 3) sensor-frame xyz, padded
    pad_mask: torch.Tensor,     # (N,) bool, True = real point
    R: torch.Tensor,            # (3, 3) sensor rotation
    t: torch.Tensor,            # (3,)  sensor translation (world frame)
    position_noise: Scalar,
    orientation_noise: Scalar,
    weights: TravFilter,
    cfg: MapConfig,
) -> MapState:
    """Full geometric update for one pointcloud (no semantic channels).

    Mirrors update_map_with_kernel (elevation_mapping.py:316-391): error
    counting -> drift compensation -> Kalman fusion -> visibility cleanup ->
    averaging -> overlap clearance -> dilation -> traversability CNN ->
    normals.
    """
    dev, dt = state.layers.device, state.layers.dtype
    position_noise = torch.as_tensor(position_noise, dtype=dt, device=dev)
    orientation_noise = torch.as_tensor(orientation_noise, dtype=dt, device=dev)

    t_c = t - state.center            # shift_translation_to_map_center
    assoc = associate_points(points[:, :3], pad_mask, R, t_c, cfg)

    layers = state.layers
    # one shared row-gather of the point cells feeds both stages
    cell_rows = pc.gather_cell_rows(layers, assoc.flat_idx)
    counts = pc.error_counting(layers, assoc, cfg, cell_rows)
    layers, mean_error, additive, h_delta = pc.apply_drift_compensation(
        layers,
        counts,
        position_noise,
        orientation_noise,
        state.mean_error,
        state.additive_mean_error,
        cfg,
    )
    # fusion decisions read the drift-compensated snapshot (R1)
    layers, newmap = pc.point_fusion(layers, assoc, counts.point_cnt, cfg, cell_rows, h_delta)
    layers = rc.visibility_cleanup(layers, state.normal, assoc, counts.inlier_cnt, t_c, cfg)
    layers = pc.average_map(layers, newmap, cfg)

    if cfg.enable_overlap_clearance:
        layers = pc.clear_overlap(layers, t_c, cfg)
    trav_input, _ = stencil.dilation_fill(layers[5], layers[2] + layers[6], cfg.dilation_size)
    layers = _apply_traversability(layers, trav_input, weights)
    normal = stencil.surface_normals(trav_input, layers[2], cfg.resolution)
    return state._replace(
        layers=layers,
        normal=normal,
        mean_error=mean_error,
        additive_mean_error=additive,
    )


def _apply_traversability(layers: torch.Tensor, trav_input: torch.Tensor, weights: TravFilter) -> torch.Tensor:
    trav = weights(trav_input)
    out = layers.clone()
    out[3, 3:-3, 3:-3] = trav.to(layers.dtype)
    return out


@torch.no_grad()
def update_normal(state: MapState, input_map: torch.Tensor, cfg: MapConfig) -> MapState:
    """Recompute normals from an arbitrary height layer (elevation_mapping.py:564-577)."""
    return state._replace(normal=stencil.surface_normals(input_map, state.layers[2], cfg.resolution))


# ---------------------------------------------------------------------------
# recentering (elevation_mapping.py:139-226)
# ---------------------------------------------------------------------------

def _roll_pad(x: torch.Tensor, s0: int, s1: int, value: float) -> torch.Tensor:
    """Roll the last two axes by (s0, s1) and set the revealed rows and
    columns to ``value`` (cp.roll + pad_value)."""
    out = torch.roll(x, shifts=(s0, s1), dims=(-2, -1))
    if s0 > 0:
        out[..., :s0, :] = value
    elif s0 < 0:
        out[..., s0:, :] = value
    if s1 > 0:
        out[..., :, :s1] = value
    elif s1 < 0:
        out[..., :, s1:] = value
    return out


def shift_map_xy(state: MapState, s0: int, s1: int, cfg: MapConfig) -> MapState:
    """Roll all layer stacks by integer cells (s0 along rows, s1 along
    columns); newly revealed cells reset (variance to initial_variance,
    everything else 0)."""
    layers = _roll_pad(state.layers, s0, s1, 0.0)
    layers[1] = _roll_pad(state.layers[1], s0, s1, cfg.initial_variance)
    return state._replace(
        layers=layers,
        semantic=_roll_pad(state.semantic, s0, s1, 0.0),
        sem_new=_roll_pad(state.sem_new, s0, s1, 0.0),
        id_max=_roll_pad(state.id_max, s0, s1, 0),
    )


def shift_map_z(state: MapState, delta_z: torch.Tensor) -> MapState:
    layers = state.layers.clone()
    layers[0] += delta_z
    layers[5] += delta_z
    return state._replace(layers=layers)


def _pixel_shift(delta_xy: torch.Tensor, cfg: MapConfig):
    """round(delta / resolution) as a tensor, and as host ints for torch.roll."""
    delta_pixel = torch.round(true_div(delta_xy, cfg.resolution))
    # the one read-back of the update: torch.roll takes integer shifts
    s0, s1 = (int(v) for v in delta_pixel.tolist())
    return delta_pixel, s0, s1


@torch.no_grad()
def move_to(state: MapState, position: torch.Tensor, R: torch.Tensor, cfg: MapConfig) -> MapState:
    """Shift the map to an absolute position (elevation_mapping.py:154-170).

    Reads the whole-cell shift back to the host once, for ``torch.roll``."""
    delta = position - state.center
    delta_pixel, s0, s1 = _pixel_shift(delta[:2], cfg)
    center = state.center.clone()
    center[:2] += delta_pixel * cfg.resolution
    center[2] += delta[2]
    state = state._replace(center=center, rotation=R.to(state.rotation.dtype))
    state = shift_map_xy(state, -s0, -s1, cfg)
    return shift_map_z(state, -delta[2])


@torch.no_grad()
def move(state: MapState, delta_position: torch.Tensor, cfg: MapConfig) -> MapState:
    """Relative shift (elevation_mapping.py:139-152). Like ``move_to``, reads
    the whole-cell shift back to the host once."""
    delta_pixel, s0, s1 = _pixel_shift(delta_position[:2], cfg)
    center = state.center.clone()
    center[:2] += delta_pixel * cfg.resolution
    center[2] += delta_position[2]
    state = state._replace(center=center)
    state = shift_map_xy(state, s0, s1, cfg)
    return shift_map_z(state, -delta_position[2])


# ---------------------------------------------------------------------------
# timers & maintenance (elevation_mapping.py:119-127, 420-432)
# ---------------------------------------------------------------------------

@torch.no_grad()
def update_variance(state: MapState, cfg: MapConfig) -> MapState:
    layers = state.layers.clone()
    layers[1] += cfg.time_variance * state.layers[2]
    return state._replace(layers=layers)


@torch.no_grad()
def update_time(state: MapState, cfg: MapConfig) -> MapState:
    layers = state.layers.clone()
    layers[4] += cfg.time_interval
    return state._replace(layers=layers)


@torch.no_grad()
def update_upper_bound_with_valid_elevation(state: MapState) -> MapState:
    mask = state.layers[2] > 0.5
    layers = state.layers.clone()
    layers[5] = torch.where(mask, layers[0], layers[5])
    layers[6] = torch.where(mask, 0.0, layers[6])
    return state._replace(layers=layers)


@torch.no_grad()
def clear(state: MapState, cfg: MapConfig) -> MapState:
    layers = torch.zeros_like(state.layers)
    layers[1] = cfg.initial_variance
    return state._replace(
        layers=layers,
        semantic=torch.zeros_like(state.semantic),
        sem_new=torch.zeros_like(state.sem_new),
        id_max=torch.zeros_like(state.id_max),
        mean_error=torch.zeros_like(state.mean_error),
        additive_mean_error=torch.zeros_like(state.additive_mean_error),
    )
