"""Procedural terrains and depth clouds of batched datagen, made from a seed.

A frozen copy of the terrain and sensor generators of the program's
``runtime/datagen.py`` (multi-octave value noise plus terraces, the kind of
terrain curricula give legged robots; a depth sensor's samples of it within
its field of view, with millimetre noise), extended by a sensor that moves
across the terrain. Every map of a batch has its own terrain for an
episode; the sensor stands ``sensor_pos`` above the robot, which advances
``advance_m`` along x a step. Parameters come from a traffic file; the
draws from one ``torch.Generator`` on the device.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence

import torch

__all__ = ["Episode", "make_episode", "make_pool", "terrain"]


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _smoothstep(t: torch.Tensor) -> torch.Tensor:
    return t * t * (3.0 - 2.0 * t)


def _value_noise(lattice: torch.Tensor, cells: int, scale: int) -> torch.Tensor:
    """Bilinear value noise: the coarse lattice upsampled smoothly to
    (..., cells, cells)."""
    dev = lattice.device
    c = _div(torch.arange(cells, dtype=torch.float32, device=dev), float(scale))
    c0 = torch.floor(c)
    i0, tt = c0.to(torch.int64), _smoothstep(c - c0)
    ty, tx = tt[:, None], tt[None, :]
    rows0, rows1 = lattice[..., i0, :], lattice[..., i0 + 1, :]
    v00, v01 = rows0[..., i0], rows0[..., i0 + 1]
    v10, v11 = rows1[..., i0], rows1[..., i0 + 1]
    return v00 * (1 - ty) * (1 - tx) + v01 * (1 - ty) * tx + v10 * ty * (1 - tx) + v11 * ty * tx


def _scales(cells: int, octaves: int) -> List[int]:
    scales, scale = [], max(cells // 4, 2)
    for _ in range(octaves):
        scales.append(max(scale, 2))
        scale //= 2
    return scales


def terrain(gen: torch.Generator, batch: int, cells: int, spec: Dict) -> torch.Tensor:
    """(batch, cells, cells) height fields: noise octaves of falling
    amplitude plus terraces of ``step_height``."""
    dev = gen.device
    scales = _scales(cells, spec["octaves"]) + [max(cells // 3, 2)]
    lattices = [torch.rand((batch, cells // s + 2, cells // s + 2), generator=gen, device=dev) * 2.0 - 1.0
                for s in scales]
    h = torch.zeros((batch, cells, cells), dtype=torch.float32, device=dev)
    amp = spec["roughness"]
    for lattice, scale in zip(lattices[:-1], scales[:-1]):
        h = h + amp * _value_noise(lattice, cells, scale)
        amp *= 0.5
    return h + torch.round(_value_noise(lattices[-1], cells, scales[-1]) * 2) * spec["step_height"]


def _cloud(gen: torch.Generator, height: torch.Tensor, resolution: float, sensor: torch.Tensor, n: int,
           fov_deg: float, noise_m: float) -> torch.Tensor:
    """(B, n, 3) samples of each map's terrain within the sensor's field of
    view, in the sensor's frame (identity rotation)."""
    b, cells = height.shape[0], height.shape[-1]
    dev = height.device
    angle = torch.rand((b, n), generator=gen, device=dev) * (2 * math.pi)
    radius_u = torch.rand((b, n), generator=gen, device=dev)
    noise = torch.randn((b, n), generator=gen, device=dev)
    half = cells * resolution / 2
    sx, sy, sz = (sensor[:, i, None] for i in range(3))
    r_max = sz * math.tan(math.radians(fov_deg / 2)) + 1.0
    rad = torch.sqrt(radius_u) * r_max
    x = torch.clamp(sx + rad * torch.cos(angle), -half, half - 1e-4)
    y = torch.clamp(sy + rad * torch.sin(angle), -half, half - 1e-4)
    ix = torch.clamp(_div(x + half, resolution).to(torch.int64), 0, cells - 1)
    iy = torch.clamp(_div(y + half, resolution).to(torch.int64), 0, cells - 1)
    z = torch.gather(height.flatten(-2), -1, ix * cells + iy) + noise_m * noise
    return torch.stack([x, y, z], dim=-1) - sensor[:, None, :]


class Episode(NamedTuple):
    """One episode of a batch: per step the cloud (B, N, 3), the robot's
    base position (B, 3) and the sensor's position (B, 3)."""

    clouds: List[torch.Tensor]
    base: List[torch.Tensor]
    sensor: List[torch.Tensor]


@torch.no_grad()
def make_episode(gen: torch.Generator, traffic: Dict, cells: int, resolution: float) -> Episode:
    b, n, steps = traffic["maps"], traffic["points"], traffic["episode_steps"]
    dev = gen.device
    height = terrain(gen, b, cells, traffic["terrain"])
    clouds, base, sensor = [], [], []
    for s in range(steps):
        pos = torch.tensor([traffic["advance_m"] * s, 0.0, 0.0], device=dev).expand(b, 3).contiguous()
        sen = pos + torch.tensor(traffic["sensor_pos"], dtype=torch.float32, device=dev)
        clouds.append(_cloud(gen, height, resolution, sen, n, traffic["fov_deg"], traffic["noise_m"]).contiguous())
        base.append(pos)
        sensor.append(sen.contiguous())
    return Episode(clouds, base, sensor)


def make_pool(seed: int, traffic: Dict, cells: int, resolution: float, device) -> Sequence[Episode]:
    """The pool of episodes a run cycles through."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [make_episode(gen, traffic, cells, resolution) for _ in range(traffic["pool_episodes"])]
