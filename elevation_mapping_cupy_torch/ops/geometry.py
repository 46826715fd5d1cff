"""Grid geometry: point->cell association and validity ramp.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/ops/geometry.py``
(reference CUDA helpers custom_kernels.py:20-108: get_x_idx / get_y_idx /
is_inside / get_idx / z_noise / is_valid), on whole point batches at once.

Index convention (matches reference): flat index ``idx = W * ix + iy`` with
``ix`` derived from world x and ``iy`` from world y; cells on the 1-cell
border are "outside" (is_inside == False).

Point tensors may carry leading batch axes, one map each: (..., N, 3)
points with (..., 3, 3) rotations and (..., 3) translations.

A :class:`Block` is a window of a map's cells (a spatially sharded map
holds one per process, ``parallel/spatial.py``): with one, the association
indexes the block's own cells and keeps only the points that land there.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import MapConfig

__all__ = [
    "true_div",
    "fma32",
    "sqrt32",
    "Block",
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


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` on float32 tensors, rounded once, as a fused multiply-add.

    XLA:CPU contracts some of the JAX package's multiply-adds into FMAs (the
    exact march's sample positions, its squared distances and dot products,
    the ray norm's reduction), and the CUDA kernel does the same with
    ``fmaf``; PyTorch has no FMA operator. This one is exact on every
    device: the product is exact in float64, the float64 sum's rounding
    error is recovered with TwoSum and folded in by rounding to odd, after
    which rounding to float32 is the single correct rounding."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    even = (s.contiguous().view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root of a float32 tensor of values >= 0.

    PyTorch's vectorised CPU ``sqrt`` is not correctly rounded (about 0.7 %
    of float32 results are an ulp off) while XLA's and CUDA's are. The
    float64 root is within an ulp of float64; the float32 candidate is then
    moved by one ulp wherever the midpoint to its neighbour, squared (exact
    in float64), shows that the true root lies on the other side."""
    r = torch.sqrt(x.double()).to(torch.float32)
    xd = x.double()
    pos = x > 0
    for direction, wrong_side in ((-math.inf, torch.gt), (math.inf, torch.lt)):
        other = torch.nextafter(r, torch.full_like(r, direction))
        mid = (r.double() + other.double()) * 0.5
        r = torch.where(pos & wrong_side(mid * mid, xd), other, r)
    return r


class Block(NamedTuple):
    """Rows ``[r0, r0 + h)`` and columns ``[c0, c0 + w)`` of a ``(gh, gw)``
    map whose flat cell index is ``gw * row + col``. Tensors of a block are
    (..., h, w); a stage given one works on those cells with their global
    positions (the map border, the cell centres, the flat neighbours)."""

    r0: int
    c0: int
    h: int
    w: int
    gh: int
    gw: int

    @staticmethod
    def whole(h: int, w: int) -> "Block":
        return Block(0, 0, h, w, h, w)

    def rows(self, device) -> torch.Tensor:
        """(h, 1) global row of each row of the block."""
        return torch.arange(self.r0, self.r0 + self.h, device=device)[:, None]

    def cols(self, device) -> torch.Tensor:
        """(1, w) global column of each column of the block."""
        return torch.arange(self.c0, self.c0 + self.w, device=device)[None, :]

    def localize(self, ix: torch.Tensor, iy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(flat index into the block, held): the block's own flat index
        ``w * (ix - r0) + (iy - c0)`` of each global cell (ix, iy) it holds,
        0 for the others."""
        held = (ix >= self.r0) & (ix < self.r0 + self.h) & (iy >= self.c0) & (iy < self.c0 + self.w)
        local = self.w * (ix - self.r0) + (iy - self.c0)
        return torch.where(held, local, 0).to(torch.int32), held

    def sub(self, other: "Block") -> Tuple[slice, slice]:
        """Slices of this block's tensors that hold ``other``, a block within
        it."""
        r, c = other.r0 - self.r0, other.c0 - self.c0
        return slice(r, r + other.h), slice(c, c + other.w)


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
    points (..., N, 3), R (..., 3, 3), t (..., 3).

    Expanded elementwise rather than as a matmul, in the JAX package's order
    of operations, so both packages round alike.
    """
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    out = [
        R[..., i, 0, None] * x + R[..., i, 1, None] * y + R[..., i, 2, None] * z + t[..., i, None]
        for i in range(3)
    ]
    return torch.stack(out, dim=-1)


def z_noise(raw_z: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """Sensor noise model: factor * z_sensor^2 (custom_kernels.py:58-60)."""
    return cfg.sensor_noise_factor * raw_z * raw_z


def point_validity(world: torch.Tensor, t: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """Validity ramp filter (custom_kernels.py:68-81): rejects points too close
    to the sensor and points above a distance-ramped ceiling. world
    (..., N, 3), t (..., 3)."""
    x, y, z = world[..., 0], world[..., 1], world[..., 2]
    d2 = torch.sum((world - t[..., None, :]) ** 2, dim=-1)
    dxy = torch.clamp(torch.sqrt(x * x + y * y) - cfg.ramped_height_range_b, min=0.0)
    too_close = d2 < cfg.min_valid_distance**2
    tz = t[..., 2, None]
    above_ramp = (z - tz) > (dxy * cfg.ramped_height_range_a + cfg.ramped_height_range_c)
    above_max = (z - tz) > cfg.max_height_range
    return ~(too_close | above_ramp | above_max)


class PointAssociation(NamedTuple):
    """Per-point association with the grid (custom_kernels.py:260-262); a
    batch of maps adds leading axes to every field."""

    world: torch.Tensor     # (N, 3) transformed points (map-center frame)
    noise: torch.Tensor     # (N,)   per-point z noise
    flat_idx: torch.Tensor  # (N,)   int32 flat cell index (clamped)
    valid: torch.Tensor     # (N,)   bool validity-ramp result
    inside: torch.Tensor    # (N,)   bool inside-border result
    mask: torch.Tensor      # (N,)   bool = valid & inside & not-padding

    def map(self, b: int) -> "PointAssociation":
        """Map ``b``'s association out of a batched one (views)."""
        return PointAssociation(*(f[b] for f in self))


def associate_points(
    points: torch.Tensor,
    pad_mask: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    cfg: MapConfig,
    block: Optional[Block] = None,
) -> PointAssociation:
    """Transform, classify, and bin a (possibly padded) pointcloud.

    ``points``: (..., N, 3) raw sensor-frame xyz; ``pad_mask``: (..., N)
    True for real points; ``R`` (..., 3, 3); ``t`` (..., 3), already in the
    map-center frame. Leading axes are a batch of maps.

    With a ``block``, ``flat_idx`` indexes the block's cells and ``inside``
    (and so ``mask``) holds only for points that land in the block; every
    ray stays ``valid``, since a ray's march crosses cells of any block.
    """
    world = transform_points(points, R, t)
    noise = z_noise(points[..., 2], cfg)
    ix, iy = cell_indices(world[..., :2], torch.zeros((2,), dtype=world.dtype, device=world.device), cfg)
    valid = point_validity(world, t, cfg) & pad_mask
    inside = is_inside(ix, iy, cfg)
    if block is None:
        flat = flat_cell_index(ix, iy, cfg)
    else:
        flat, held = block.localize(ix, iy)
        inside = inside & held
    return PointAssociation(
        world=world,
        noise=noise,
        flat_idx=flat,
        valid=valid,
        inside=inside,
        mask=valid & inside & pad_mask,
    )
