"""Procedural terrains and simulated depth/LiDAR sensors for batched datagen.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/runtime/datagen.py``:
thousands of independent maps updated per step from synthetic sensors (sim
datagen, RL terrain curricula), made on the device so that the datagen ->
update loop never leaves it.

``jax.random``'s bits cannot be reproduced with a ``torch.Generator``, so
every function is split in two: the random draws (``draw_*``, from an
explicit generator on the device the work runs on) and the deterministic
work on them (``*_from_draws``), which given the draws the JAX package made
computes what the JAX function computes. The top-level functions are the
two halves together.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple, Union

import torch

from ..ops.geometry import true_div

__all__ = [
    "make_generator",
    "value_noise",
    "terrain_lattice_shapes",
    "draw_terrain",
    "terrain_from_draws",
    "procedural_terrain",
    "CloudDraws",
    "draw_cloud",
    "cloud_from_draws",
    "simulate_depth_cloud",
    "BatchDraws",
    "draw_batch_clouds",
    "batch_clouds_from_draws",
    "make_batch_clouds",
]

SENSOR_POS = (0.0, 0.0, 0.8)   # make_batch_clouds' sensor, in the map frame


def make_generator(seed: int, device: Union[None, str, torch.device] = None) -> torch.Generator:
    """A seeded generator on ``device`` (CUDA unless asked for ``"cpu"``)."""
    from ..mapper import resolve_device

    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def _smoothstep(t: torch.Tensor) -> torch.Tensor:
    return t * t * (3.0 - 2.0 * t)


def value_noise(lattice: torch.Tensor, shape: Tuple[int, int], scale: int) -> torch.Tensor:
    """Bilinear value noise: the coarse (..., h // scale + 2, w // scale + 2)
    lattice upsampled smoothly to (..., h, w)."""
    h, w = shape
    dev = lattice.device

    def axis(m):
        c = true_div(torch.arange(m, dtype=torch.float32, device=dev), float(scale))
        c0 = torch.floor(c)
        return c0.to(torch.int64), _smoothstep(c - c0)

    y0, ty = axis(h)
    x0, tx = axis(w)
    ty, tx = ty[:, None], tx[None, :]
    rows0, rows1 = lattice[..., y0, :], lattice[..., y0 + 1, :]
    v00, v01 = rows0[..., x0], rows0[..., x0 + 1]
    v10, v11 = rows1[..., x0], rows1[..., x0 + 1]
    return v00 * (1 - ty) * (1 - tx) + v01 * (1 - ty) * tx + v10 * ty * (1 - tx) + v11 * ty * tx


def _octave_scales(cells: int, n_octaves: int) -> List[int]:
    scales, scale = [], max(cells // 4, 2)
    for _ in range(n_octaves):
        scales.append(max(scale, 2))
        scale //= 2
    return scales


def terrain_lattice_shapes(cells: int, n_octaves: int = 3) -> List[Tuple[int, int]]:
    """Shapes of the lattices a terrain draws: one per octave, then the
    terraces'."""
    scales = _octave_scales(cells, n_octaves) + [max(cells // 3, 2)]
    return [(cells // s + 2, cells // s + 2) for s in scales]


def draw_terrain(
    generator: torch.Generator, cells: int, batch: Sequence[int] = (), n_octaves: int = 3
) -> List[torch.Tensor]:
    """The random half of a terrain: its lattices, uniform in [-1, 1)."""
    return [
        torch.rand((*batch, *shape), generator=generator, device=generator.device) * 2.0 - 1.0
        for shape in terrain_lattice_shapes(cells, n_octaves)
    ]


def terrain_from_draws(
    lattices: Sequence[torch.Tensor], cells: int, roughness: float = 0.15, step_height: float = 0.25
) -> torch.Tensor:
    """(..., cells, cells) height field from the lattices of
    :func:`draw_terrain`: multi-octave noise plus random terraces, the kind
    of terrain curricula used for legged-robot training."""
    n_octaves = len(lattices) - 1
    h = torch.zeros(lattices[0].shape[:-2] + (cells, cells), dtype=torch.float32, device=lattices[0].device)
    amp = roughness
    for lattice, scale in zip(lattices, _octave_scales(cells, n_octaves)):
        h = h + amp * value_noise(lattice, (cells, cells), scale)
        amp *= 0.5
    terr = torch.round(value_noise(lattices[-1], (cells, cells), max(cells // 3, 2)) * 2) * step_height
    return h + terr


def procedural_terrain(
    generator: torch.Generator,
    cells: int,
    resolution: float,
    roughness: float = 0.15,
    step_height: float = 0.25,
    n_octaves: int = 3,
    batch: Sequence[int] = (),
) -> torch.Tensor:
    """(*batch, cells, cells) height fields on the generator's device."""
    del resolution  # the JAX signature's; the terrain is in cells
    return terrain_from_draws(draw_terrain(generator, cells, batch, n_octaves), cells, roughness, step_height)


class CloudDraws(NamedTuple):
    """The random half of a depth cloud, (..., n) each: the azimuth of each
    sample as its unit vector (cos, sin of an angle uniform in [0, 2 pi)),
    the uniform variate its radius is the square root of, and its
    standard-normal height noise. The azimuth is drawn as a vector because
    the CPU's float32 cos and sin round apart from XLA's in the last bit."""

    cos_az: torch.Tensor
    sin_az: torch.Tensor
    radius_u: torch.Tensor
    noise: torch.Tensor


def draw_cloud(generator: torch.Generator, n_points: int, batch: Sequence[int] = ()) -> CloudDraws:
    shape, dev = (*batch, n_points), generator.device
    angle = torch.rand(shape, generator=generator, device=dev) * (2 * math.pi)
    return CloudDraws(
        cos_az=torch.cos(angle),
        sin_az=torch.sin(angle),
        radius_u=torch.rand(shape, generator=generator, device=dev),
        noise=torch.randn(shape, generator=generator, device=dev),
    )


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    from ..ops.geometry import sqrt32

    return sqrt32(x) if x.device.type == "cpu" else torch.sqrt(x)


def cloud_from_draws(
    terrain: torch.Tensor,       # (..., cells, cells)
    resolution: float,
    sensor_pos: torch.Tensor,    # (..., 3) in the map frame
    draws: CloudDraws,
    fov_deg: float = 85.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Terrain surface samples in the sensor's field of view, with 5 mm of
    height noise: returns (points (..., n, 3) in the SENSOR frame (identity
    rotation), sensor translation (..., 3))."""
    cells = terrain.shape[-1]
    half = cells * resolution / 2
    sx, sy, sz = (sensor_pos[..., i, None] for i in range(3))
    fov = torch.full((), fov_deg / 2, dtype=torch.float32, device=terrain.device) * (math.pi / 180)
    r_max = sz * torch.tan(fov) + 1.0
    rad = _sqrt(draws.radius_u) * r_max
    x = torch.clamp(sx + rad * draws.cos_az, -half, half - 1e-4)
    y = torch.clamp(sy + rad * draws.sin_az, -half, half - 1e-4)
    ix = torch.clamp(true_div(x + half, resolution).to(torch.int64), 0, cells - 1)
    iy = torch.clamp(true_div(y + half, resolution).to(torch.int64), 0, cells - 1)
    flat = terrain.flatten(-2)
    z = torch.gather(flat, -1, ix * cells + iy) + 0.005 * draws.noise
    world = torch.stack([x, y, z], dim=-1)
    return world - sensor_pos[..., None, :], sensor_pos


def simulate_depth_cloud(
    generator: torch.Generator,
    terrain: torch.Tensor,
    resolution: float,
    sensor_pos: torch.Tensor,
    n_points: int,
    fov_deg: float = 85.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample a depth-camera-like pointcloud of the terrain (see
    :func:`cloud_from_draws`), drawn from ``generator``."""
    draws = draw_cloud(generator, n_points, terrain.shape[:-2])
    return cloud_from_draws(terrain, resolution, sensor_pos, draws, fov_deg)


class BatchDraws(NamedTuple):
    """The random half of :func:`make_batch_clouds`: every map's terrain
    lattices (leading axis B) and cloud draws ((B, n) each)."""

    lattices: List[torch.Tensor]
    cloud: CloudDraws


def draw_batch_clouds(generator: torch.Generator, batch: int, cells: int, n_points: int) -> BatchDraws:
    return BatchDraws(draw_terrain(generator, cells, (batch,)), draw_cloud(generator, n_points, (batch,)))


@torch.no_grad()
def batch_clouds_from_draws(
    draws: BatchDraws, cells: int, resolution: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched terrains and clouds from :func:`draw_batch_clouds`: returns
    (points (B, n, 3), t (B, 3), terrain (B, cells, cells)). Every map has
    its own terrain; the sensor stands at ``SENSOR_POS`` in each map."""
    terrain = terrain_from_draws(draws.lattices, cells)
    batch, dev = terrain.shape[0], terrain.device
    pos = torch.tensor(SENSOR_POS, dtype=torch.float32, device=dev)
    pts, t = cloud_from_draws(terrain, resolution, pos.expand(batch, 3), draws.cloud)
    return pts, t.contiguous(), terrain


def make_batch_clouds(
    generator: torch.Generator, batch: int, cells: int, resolution: float, n_points: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched terrains and clouds on the generator's device (see
    :func:`batch_clouds_from_draws`)."""
    return batch_clouds_from_draws(draw_batch_clouds(generator, batch, cells, n_points), cells, resolution)
