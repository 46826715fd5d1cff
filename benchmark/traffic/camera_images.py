"""Camera images of batched multi-modal datagen, made from a seed.

Each map of a batch carries one camera, mounted at its depth sensor and
moving with its robot: it looks along the robot's heading (+x), pitched
``camera.pitch_deg`` down, through a pinhole of the traffic's intrinsics
with radtan distortion. At each step of an episode every map's camera gives
one image of float32 planes (``planes(channels)``): ``rgb`` as three
planes of integers 0-255, then one plane a class, the classes'
probabilities (the softmax of one noise field a class). The content is seeded value noise made
on the device; what the image path does with it depends only on the
geometry, never on the pixel values. Parameters come from a traffic file
(``camera``, ``channels``); the draws from one ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence

import torch

__all__ = ["Cameras", "camera_rotation", "make_cameras", "make_pool", "planes"]

# pixels between the lattice points of the images' value noise
NOISE_SCALE = 16


def planes(channels: Sequence[str]) -> int:
    """Image planes the channels take: three for ``rgb``, one for any other."""
    return sum(3 if ch == "rgb" else 1 for ch in channels)


def camera_rotation(pitch_deg: float, device) -> torch.Tensor:
    """World to optical frame (x right, y down, z forward) of a camera that
    looks along +x, pitched ``pitch_deg`` down."""
    s, c = math.sin(math.radians(pitch_deg)), math.cos(math.radians(pitch_deg))
    return torch.tensor([[0.0, -1.0, 0.0], [-s, 0.0, -c], [c, 0.0, -s]], dtype=torch.float32, device=device)


def _noise(gen: torch.Generator, lead: Sequence[int], height: int, width: int) -> torch.Tensor:
    """(*lead, height, width) bilinear value noise in [0, 1) with a smooth
    step between lattice points ``NOISE_SCALE`` pixels apart."""
    dev = gen.device
    lattice = torch.rand((*lead, height // NOISE_SCALE + 2, width // NOISE_SCALE + 2), generator=gen, device=dev)

    def axis(n):
        c = torch.arange(n, dtype=torch.float32, device=dev) / NOISE_SCALE
        i0 = torch.floor(c)
        t = c - i0
        return i0.to(torch.int64), t * t * (3.0 - 2.0 * t)

    (iy, ty), (ix, tx) = axis(height), axis(width)
    ty, tx = ty[:, None], tx[None, :]
    rows0, rows1 = lattice[..., iy, :], lattice[..., iy + 1, :]
    return (rows0[..., ix] * (1 - ty) * (1 - tx) + rows0[..., ix + 1] * (1 - ty) * tx
            + rows1[..., ix] * ty * (1 - tx) + rows1[..., ix + 1] * ty * tx)


def _images(gen: torch.Generator, maps: int, channels: Sequence[str], height: int, width: int) -> torch.Tensor:
    """(maps, planes, height, width) images of one step: ``rgb``'s three
    planes first, then the classes'."""
    classes = [ch for ch in channels if ch != "rgb"]
    if "rgb" in channels and channels[0] != "rgb":
        raise ValueError("rgb has to be the first channel")
    out = [] if "rgb" not in channels else [
        torch.clamp(torch.floor(_noise(gen, (maps, 3), height, width) * 256.0), 0.0, 255.0)]
    if classes:
        out.append(torch.softmax(4.0 * _noise(gen, (maps, len(classes)), height, width), dim=1))
    return torch.cat(out, dim=1).contiguous()


class Cameras(NamedTuple):
    """One episode's cameras: per step the images (B, planes, H, W), the
    rotations (B, 3, 3) and translations (B, 3) of world to optical frame;
    the intrinsics (B, 3, 3) and distortion (B, 5) of every step."""

    images: List[torch.Tensor]
    R: List[torch.Tensor]
    t: List[torch.Tensor]
    K: torch.Tensor
    D: torch.Tensor


@torch.no_grad()
def make_cameras(gen: torch.Generator, traffic: Dict, sensor: Sequence[torch.Tensor]) -> Cameras:
    """The cameras of one episode whose depth sensors stand at ``sensor``
    (per step, (B, 3) in the world)."""
    cam, dev = traffic["camera"], gen.device
    b = sensor[0].shape[0]
    rot = camera_rotation(cam["pitch_deg"], dev)
    K = torch.tensor([[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]], [0.0, 0.0, 1.0]],
                     dtype=torch.float32, device=dev)
    D = torch.tensor(cam["D"], dtype=torch.float32, device=dev)
    images, R, t = [], [], []
    for pos in sensor:
        images.append(_images(gen, b, traffic["channels"], cam["height"], cam["width"]))
        R.append(rot.expand(b, 3, 3).contiguous())
        t.append(-(rot[None] * pos[:, None, :]).sum(dim=-1))
    return Cameras(images, R, t, K.expand(b, 3, 3).contiguous(), D.expand(b, 5).contiguous())


def make_pool(seed: int, traffic: Dict, episodes: Sequence, device) -> List[Cameras]:
    """The cameras of each episode of a pool of ``terrain_clouds`` episodes,
    from a generator of their own (the pool's clouds stay those of the seed)."""
    gen = torch.Generator(device=device).manual_seed(seed + (1 << 40))
    return [make_cameras(gen, traffic, ep.sensor) for ep in episodes]
