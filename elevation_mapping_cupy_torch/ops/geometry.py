"""Grid geometry: point->cell association and validity ramp.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/ops/geometry.py``
(reference CUDA helpers custom_kernels.py:20-108: get_x_idx / get_y_idx /
is_inside / get_idx / z_noise / is_valid), on whole point batches at once.

Index convention (matches reference): flat index ``idx = W * ix + iy`` with
``ix`` derived from world x and ``iy`` from world y; cells on the 1-cell
border are "outside" (is_inside == False).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import MapConfig

__all__ = [
    "true_div",
    "cell_indices",
    "is_inside",
    "flat_cell_index",
    "transform_points",
    "z_noise",
    "point_validity",
    "PointAssociation",
    "associate_points",
]


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded as one IEEE division.

    On a CUDA tensor PyTorch turns division by a Python scalar into a
    multiplication by its reciprocal, which can round differently by an ulp;
    where the quotient is truncated to a cell index that ulp moves points
    across cell edges. Dividing by a 0-d tensor on the same device keeps the
    true division on every device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _axis_index(coord: torch.Tensor, center: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """(x - c)/res + 0.5*W, C-truncated toward zero (custom_kernels.py:26-33),
    clamped to [0, n-1]. The clamp comes before the float->int cast (a cast
    of an out-of-range float is undefined); for in-range values
    trunc(clamp(f)) equals the JAX package's clip(trunc(f))."""
    f = true_div(coord - center, cfg.resolution) + 0.5 * cfg.cell_n
    return torch.trunc(torch.clamp(f, 0.0, cfg.cell_n - 1)).to(torch.int32)


def cell_indices(
    xy: torch.Tensor, center_xy: torch.Tensor, cfg: MapConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clamped (ix, iy) per point. xy: (N, 2)."""
    ix = _axis_index(xy[..., 0], center_xy[0], cfg)
    iy = _axis_index(xy[..., 1], center_xy[1], cfg)
    return ix, iy


def flat_cell_index(ix: torch.Tensor, iy: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    return cfg.cell_n * ix + iy


def is_inside(ix: torch.Tensor, iy: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """Border cells are outside (custom_kernels.py:34-44)."""
    n = cfg.cell_n
    return (ix > 0) & (ix < n - 1) & (iy > 0) & (iy < n - 1)


def transform_points(points: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """World coordinates: R @ p + t for each point (custom_kernels.py:54-57).

    Expanded elementwise rather than as a matmul, in the JAX package's order
    of operations, so both packages round alike.
    """
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    out = [R[i, 0] * x + R[i, 1] * y + R[i, 2] * z + t[i] for i in range(3)]
    return torch.stack(out, dim=-1)


def z_noise(raw_z: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """Sensor noise model: factor * z_sensor^2 (custom_kernels.py:58-60)."""
    return cfg.sensor_noise_factor * raw_z * raw_z


def point_validity(world: torch.Tensor, t: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """Validity ramp filter (custom_kernels.py:68-81): rejects points too close
    to the sensor and points above a distance-ramped ceiling."""
    x, y, z = world[..., 0], world[..., 1], world[..., 2]
    d2 = torch.sum((world - t) ** 2, dim=-1)
    dxy = torch.clamp(torch.sqrt(x * x + y * y) - cfg.ramped_height_range_b, min=0.0)
    too_close = d2 < cfg.min_valid_distance**2
    above_ramp = (z - t[2]) > (dxy * cfg.ramped_height_range_a + cfg.ramped_height_range_c)
    above_max = (z - t[2]) > cfg.max_height_range
    return ~(too_close | above_ramp | above_max)


class PointAssociation(NamedTuple):
    """Per-point association with the grid (custom_kernels.py:260-262)."""

    world: torch.Tensor     # (N, 3) transformed points (map-center frame)
    noise: torch.Tensor     # (N,)   per-point z noise
    flat_idx: torch.Tensor  # (N,)   int32 flat cell index (clamped)
    valid: torch.Tensor     # (N,)   bool validity-ramp result
    inside: torch.Tensor    # (N,)   bool inside-border result
    mask: torch.Tensor      # (N,)   bool = valid & inside & not-padding


def associate_points(
    points: torch.Tensor,
    pad_mask: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    cfg: MapConfig,
) -> PointAssociation:
    """Transform, classify, and bin a (possibly padded) pointcloud.

    ``points``: (N, 3) raw sensor-frame xyz; ``pad_mask``: (N,) True for real
    points. ``t`` must already be in the map-center frame.
    """
    world = transform_points(points, R, t)
    noise = z_noise(points[:, 2], cfg)
    ix, iy = cell_indices(world[:, :2], torch.zeros((2,), dtype=world.dtype, device=world.device), cfg)
    flat = flat_cell_index(ix, iy, cfg)
    valid = point_validity(world, t, cfg) & pad_mask
    inside = is_inside(ix, iy, cfg)
    return PointAssociation(
        world=world,
        noise=noise,
        flat_idx=flat,
        valid=valid,
        inside=inside,
        mask=valid & inside & pad_mask,
    )
