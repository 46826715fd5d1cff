"""A robot's LiDAR frames of a synthetic scene, made from a seed.

The scene of the smoke test's ``scene_cloud``: flat ground with boxes,
points around the sensor whose density falls with range like a lidar's, a
share of them on the boxes' tops and sides, centimetre noise. The robot
drives ``robot_pose``'s arc. Each frame is handed out as PointCloud2-style
records (x, y, z and padding floats) with a share of the returns NaN (no
return). Every parameter comes from a traffic file's ``scene`` and ``path``
blocks; the draws come from one ``torch.Generator`` on the device, frames
in chunks, so that a run's set-up makes them in a few large calls.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["robot_pose", "make_frames"]


def robot_pose(k: int, path: Dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(R, sensor translation, robot position) of frame ``k``: the robot
    advances ``step_m`` (x, y) and turns ``yaw_deg`` a frame, the sensor
    ``sensor_height_m`` above it."""
    yaw = math.radians(path["yaw_deg"] * k)
    c, s = math.cos(yaw), math.sin(yaw)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    pos = np.array([path["step_m"][0] * k, path["step_m"][1] * k, 0.0], np.float32)
    return R, pos + np.array([0.0, 0.0, path["sensor_height_m"]], np.float32), pos


def _chunk(gen: torch.Generator, R: torch.Tensor, t: torch.Tensor, n: int, scene: Dict, nan_share: float,
           fields: int) -> torch.Tensor:
    """(F, n, fields) float32 records of F frames (R (F, 3, 3), t (F, 3))."""
    dev = gen.device
    f = R.shape[0]
    rand = lambda *shape: torch.rand((f, *shape), generator=gen, device=dev)  # noqa: E731
    n_wall = int(n * scene["wall_share"])
    n_ground = n - n_wall
    r_max = scene["r_max"]
    r = 0.4 + (r_max - 0.4) * rand(n_ground) ** 1.5
    a = (rand(n_ground) * 2.0 - 1.0) * math.pi
    x = t[:, 0, None] + r * torch.cos(a)
    y = t[:, 1, None] + r * torch.sin(a)
    z = torch.zeros_like(x)
    boxes = torch.tensor(scene["boxes"], dtype=torch.float32, device=dev)
    for x0, y0, x1, y1, h in scene["boxes"]:
        z = torch.where((x >= x0) & (x <= x1) & (y >= y0) & (y <= y1), h, z)
    b = boxes[torch.randint(0, len(boxes), (f, n_wall), generator=gen, device=dev)]
    u = rand(n_wall)
    side = torch.randint(0, 4, (f, n_wall), generator=gen, device=dev)
    wx = torch.where(side < 2, b[..., 0] + u * (b[..., 2] - b[..., 0]), torch.where(side == 2, b[..., 0], b[..., 2]))
    wy = torch.where(side >= 2, b[..., 1] + u * (b[..., 3] - b[..., 1]), torch.where(side == 0, b[..., 1], b[..., 3]))
    wz = rand(n_wall) * b[..., 4]
    world = torch.stack([torch.cat([x, wx], 1), torch.cat([y, wy], 1), torch.cat([z, wz], 1)], -1)
    world = world + scene["noise_m"] * torch.randn(world.shape, generator=gen, device=dev)
    pts = torch.einsum("fnj,fjk->fnk", world - t[:, None, :], R)  # R^T (p - t), row-wise
    rec = torch.zeros((f, n, fields), dtype=torch.float32, device=dev)
    rec[..., :3] = pts
    bad = rand(n) < nan_share
    coord = torch.randint(0, 3, (f, n), generator=gen, device=dev)
    for c in range(3):
        rec[..., c] = torch.where(bad & (coord == c), math.nan, rec[..., c])
    return rec


# frames made together; each chunk draws from its own generator, so that
# frame k is the same whatever the number of frames asked for
CHUNK = 32


@torch.no_grad()
def make_frames(seed: int, count: int, traffic: Dict, device) -> Tuple[np.ndarray, List[Tuple]]:
    """``count`` frames of the traffic from ``seed``: (records (count, n,
    point_step / 4) float32 on the host, poses [(R, t, position)])."""
    n, fields = traffic["points"], traffic["point_step"] // 4
    poses = [robot_pose(k, traffic["path"]) for k in range(count + CHUNK)]
    out = np.empty((count, n, fields), np.float32)
    for c, k0 in enumerate(range(0, count, CHUNK)):
        gen = torch.Generator(device=device).manual_seed((seed + c * 0x9E3779B97F4A7C15) % 2**64)
        sel = poses[k0:k0 + CHUNK]
        R = torch.as_tensor(np.stack([p[0] for p in sel]), device=device)
        t = torch.as_tensor(np.stack([p[1] for p in sel]), device=device)
        rec = _chunk(gen, R, t, n, traffic["scene"], traffic["nan_share"], fields)
        out[k0:k0 + CHUNK] = rec[: min(CHUNK, count - k0)].cpu().numpy()
    return out, poses[:count]
