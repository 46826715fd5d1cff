"""Image->map correspondence and image-channel fusion.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/ops/image.py``, a
re-derivation of the reference image kernels (custom_image_kernels.py):
  * image_to_map_correspondence_kernel (:9-157): per cell, project the cell's
    3D point through P = K[R|t] with radtan undistortion, then test whether
    the height map occludes the cell from the camera. ``"shadow"`` (the
    default) answers that with a camera-centric polar shadow map;
    ``"bresenham"`` walks the height map from the cell toward the camera
    cell as the reference's per-thread loop does, here as a host loop of at
    most 2*cell_n steps over all cells with per-cell done flags.
  * average/exponential/color_correspondences_to_map_kernel (:160-271):
    gather image pixels at the uv correspondence into semantic layers.

Quotients that decide a pixel or a bin are tensor-by-tensor divisions (a
CUDA tensor divided by a Python scalar is multiplied by its reciprocal).

Every function also takes a batch of maps, each with its own camera: a
leading axis on every argument. The shadow map of each map is its own
(azimuth, radius) grid inside one scatter; the Bresenham walk steps every
cell of every map together.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .. import tracing
from ..config import MapConfig
from ..semantic.fusions import uint_to_rgb_float
from . import scatter
from .geometry import sqrt32

__all__ = [
    "image_to_map_correspondence",
    "image_fuse_replace",
    "image_fuse_exponential",
    "image_fuse_color",
]

# the Bresenham walk asks the device whether every cell is done once per
# this many steps (one read-back each, counted as a blocking transfer); a
# finished walk changes nothing, so stopping early gives the same result as
# all 2*cell_n steps
BRESENHAM_CHECK_EVERY = 8


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 root: CUDA's ``sqrt`` is, PyTorch's
    vectorised CPU one is not (``geometry.sqrt32``)."""
    return sqrt32(x) if x.device.type == "cpu" else torch.sqrt(x)


def image_to_map_correspondence(
    layers: torch.Tensor,       # (7, H, W)
    center: torch.Tensor,       # (3,) map center (world)
    cam_xy_cell: torch.Tensor,  # (2,) camera cell (x1, y1), integer
    cam_z: torch.Tensor,        # () camera height (map frame)
    P: torch.Tensor,            # (3, 4) projection
    K: torch.Tensor,            # (3, 3) intrinsics
    D: torch.Tensor,            # (5,) radtan distortion
    image_height: float,
    image_width: float,
    cfg: MapConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (uv (2, H, W), valid (H, W) bool); with a leading batch axis
    on every tensor argument, (B, 2, H, W) and (B, H, W)."""
    single = layers.dim() == 3
    if single:
        layers, center, cam_xy_cell, cam_z, P, K, D = (
            x[None] for x in (layers, center, cam_xy_cell, cam_z, P, K, D)
        )
    nb = layers.shape[0]
    n = cfg.cell_n
    dt = layers.dtype
    flat_h = layers[:, 0].flatten(-2)     # (B, n*n)
    flat_valid = layers[:, 2].flatten(-2)

    i = torch.arange(n * n, device=layers.device)
    x0 = i // n
    y0 = i % n

    has_height = flat_valid == 1.0

    def col(m, r, c):  # one entry per map, against the (B, n*n) cells
        return m[:, r, c, None]

    # cell 3D point in world frame (custom_image_kernels.py:47-50)
    p1 = (x0.to(dt) - n / 2) * cfg.resolution + center[:, 0, None]
    p2 = (y0.to(dt) - n / 2) * cfg.resolution + center[:, 1, None]
    p3 = flat_h + center[:, 2, None]

    u = p1 * col(P, 0, 0) + p2 * col(P, 0, 1) + p3 * col(P, 0, 2) + col(P, 0, 3)
    v = p1 * col(P, 1, 0) + p2 * col(P, 1, 1) + p3 * col(P, 1, 2) + col(P, 1, 3)
    d = p1 * col(P, 2, 0) + p2 * col(P, 2, 1) + p3 * col(P, 2, 2) + col(P, 2, 3)
    in_front = d > 0
    safe_d = torch.where(in_front, d, 1.0)
    u = u / safe_d
    v = v / safe_d

    # radtan undistortion (custom_image_kernels.py:64-86)
    is_D_zero = torch.all(D[:, :5] == 0, dim=-1)[:, None]
    k1, k2, pp1, pp2, k3 = (D[:, j, None] for j in range(5))
    fx, fy, cx, cy = col(K, 0, 0), col(K, 1, 1), col(K, 0, 2), col(K, 1, 2)
    xn = (u - cx) / fx
    yn = (v - cy) / fy
    r2 = xn * xn + yn * yn
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    u_c = xn * radial + 2 * pp1 * xn * yn + pp2 * (r2 + 2 * xn * xn)
    v_c = yn * radial + 2 * pp2 * xn * yn + pp1 * (r2 + 2 * yn * yn)
    u = torch.where(is_D_zero, u, fx * u_c + cx)
    v = torch.where(is_D_zero, v, fy * v_c + cy)

    in_image = (u >= 0) & (v >= 0) & (u < image_width) & (v < image_height)
    candidate = has_height & in_front & in_image

    x1 = cam_xy_cell[:, 0, None].to(torch.int64)
    y1 = cam_xy_cell[:, 1, None].to(torch.int64)
    cz = cam_z[:, None]

    with tracing.span("image.occlusion", stream=layers.is_cuda):
        if cfg.image_occlusion_mode == "shadow":
            blocked = _occlusion_shadow(flat_h, flat_valid, x0, y0, x1, y1, cz, cfg)
        else:
            blocked = _occlusion_bresenham(flat_h, flat_valid, candidate, x0, y0, x1, y1, cz, cfg)

    uv = torch.stack([u, v], dim=1).reshape(nb, 2, n, n)
    valid = (candidate & ~blocked).reshape(nb, n, n)
    # cells that failed the early-return gates keep zeroed uv (buffer cleared
    # before the kernel in the reference, elevation_mapping.py:536-537)
    uv = torch.where(candidate.reshape(nb, 1, n, n), uv, 0.0)
    return (uv[0], valid[0]) if single else (uv, valid)


def _occlusion_bresenham(
    flat_h: torch.Tensor,
    flat_valid: torch.Tensor,
    candidate: torch.Tensor,
    x0: torch.Tensor,
    y0: torch.Tensor,
    x1: torch.Tensor,
    y1: torch.Tensor,
    cam_z: torch.Tensor,
    cfg: MapConfig,
) -> torch.Tensor:
    """Bresenham march from every cell toward the camera cell
    (custom_image_kernels.py:100-147): blocked where a valid cell on the
    line stands more than ``tolerance_z_collision`` above the ray. Maps are
    (B, n*n), the camera cell and height (B, 1)."""
    n = cfg.cell_n
    dt = flat_h.dtype
    total_dis = _sqrt((x0 - x1).to(dt) ** 2 + (y0 - y1).to(dt) ** 2)
    z0 = flat_h
    delta_z = cam_z - z0
    dx = torch.abs(x1 - x0)
    sx = torch.where(x0 < x1, 1, -1)
    dy = -torch.abs(y1 - y0)
    sy = torch.where(y0 < y1, 1, -1)
    has_total = total_dis > 0
    safe_total = torch.where(has_total, total_dis, 1.0)
    obstacle = flat_h - cfg.tolerance_z_collision

    cx_, cy_, err = x0.expand_as(dx), y0.expand_as(dy), dx + dy
    done = ~candidate
    blocked = torch.zeros_like(candidate)
    for step in range(2 * n):
        if step % BRESENHAM_CHECK_EVERY == 0 and bool(tracing.read_back(done.all())):
            break
        at_cam = (cx_ == x1) & (cy_ == y1)
        done = done | at_cam

        inside = (cx_ >= 0) & (cy_ >= 0) & (cx_ < n) & (cy_ < n)
        idxc = torch.clamp(cy_ + cx_ * n, 0, n * n - 1)
        cell_has = torch.gather(flat_valid, -1, idxc) != 0
        dis = _sqrt((x0 - cx_).to(dt) ** 2 + (y0 - cy_).to(dt) ** 2)
        rayheight = z0 + torch.where(has_total, dis / safe_total, 0.0) * delta_z
        collide = ~done & inside & cell_has & (torch.gather(obstacle, -1, idxc) > rayheight)
        blocked = blocked | collide
        done = done | collide

        e2 = 2 * err
        move_x = e2 >= dy
        stop_x = move_x & (cx_ == x1)
        go_x = ~done & move_x & ~stop_x
        err = torch.where(go_x, err + dy, err)
        cx_n = torch.where(go_x, cx_ + sx, cx_)
        move_y = e2 <= dx
        stop_y = move_y & (cy_ == y1)
        go_y = ~done & ~stop_x & move_y & ~stop_y
        err = torch.where(go_y, err + dx, err)
        cy_n = torch.where(go_y, cy_ + sy, cy_)
        done = done | stop_x | (move_y & stop_y)
        cx_, cy_ = cx_n, cy_n
    return blocked


def _occlusion_shadow(
    flat_h: torch.Tensor,
    flat_valid: torch.Tensor,
    x0: torch.Tensor,
    y0: torch.Tensor,
    x1: torch.Tensor,
    y1: torch.Tensor,
    cam_z: torch.Tensor,
    cfg: MapConfig,
) -> torch.Tensor:
    """Camera-centric shadow map — the data-parallel formulation of the
    Bresenham occlusion walk (custom_image_kernels.py:100-147).

    Identity: the march's collision test ``h' - tol > rayheight(dis)`` along
    the cell→camera line is, measured from the camera, exactly
    ``(h' - tol - cam_z)/r' > (z0 - cam_z)/r_cell`` — an elevation-angle
    comparison. So per azimuth bin around the camera cell a radial
    prefix-max of obstacle slopes answers every cell's visibility at once:
    one scatter-max over the cells + a prefix scan + windowed gathers,
    replacing 2*cell_n gather rounds over the whole map.

    Azimuth windows use the same crossing-band geometry as the polar
    raycast (ops/raycast.py): a line at angle theta sweeps cells over a
    perpendicular band of width |cos|+|sin| cells, widened into a ring
    max-pyramid query so near-camera cells consult enough bins.

    Maps are (B, n*n), the camera cell and height (B, 1); each map's
    shadow grid is its own (A, R) block of one scatter-max.
    """
    n = cfg.cell_n
    nb = flat_h.shape[0]
    A = cfg.image_occlusion_azimuth_bins
    R = int(math.ceil(n * math.sqrt(2.0))) + 2
    dt = flat_h.dtype
    two_pi = 2.0 * math.pi

    dx = (x0 - x1).to(dt)
    dy = (y0 - y1).to(dt)
    r = torch.sqrt(dx * dx + dy * dy)
    az = torch.atan2(dy, dx)
    a_idx = torch.clamp(((az + math.pi) * (A / two_pi)).to(torch.int64), 0, A - 1)
    r_idx = torch.clamp(torch.round(r).to(torch.int64), 0, R - 1)

    has = flat_valid != 0
    safe_r = torch.clamp(r, min=1e-6)
    s_obs = (flat_h - cfg.tolerance_z_collision - cam_z) / safe_r
    part = has & (r > 0.5)

    cube = scatter.scatter_max(A * R, a_idx * R + r_idx, s_obs, part, -math.inf).reshape(nb, A, R)
    pref = torch.cummax(cube, dim=-1).values  # incl. own bin

    # ring max-pyramid over azimuth (level l covers [a, a + 2^l))
    n_levels = min(10, max(1, math.ceil(math.log2(A))))
    levels = [pref]
    for l in range(1, n_levels + 1):
        prev = levels[-1]
        levels.append(torch.maximum(prev, torch.roll(prev, -(1 << (l - 1)), dims=1)))
    pyr_flat = torch.stack(levels, dim=1).reshape(nb, (n_levels + 1) * A * R)  # (B, L+1, A, R)

    # azimuth crossing band of the line at this cell's angle (cell units)
    band = torch.abs(torch.cos(az)) + torch.abs(torch.sin(az))
    half_ang = torch.atan2(0.5 * band, safe_r)
    hw = torch.clamp((half_ang * (A / two_pi)).to(torch.int64), 0, A // 2 - 1)
    lo = a_idx - hw
    width = 2 * hw + 1
    lvl = torch.clamp(torch.ceil(torch.log2(width.to(dt))).to(torch.int64), 0, n_levels)
    start1 = lo % A
    start2 = (lo + width - torch.bitwise_left_shift(torch.ones_like(lvl), lvl)) % A
    rq = torch.clamp(r_idx - 1, min=0)  # strictly-closer bins only
    m1 = torch.gather(pyr_flat, -1, (lvl * A + start1) * R + rq)
    m2 = torch.gather(pyr_flat, -1, (lvl * A + start2) * R + rq)
    shadow = torch.maximum(m1, m2)

    s_cell = (flat_h - cam_z) / safe_r
    return (r_idx >= 1) & (shadow > s_cell)


def _gather_pixels(image: torch.Tensor, uv: torch.Tensor, image_width: float) -> torch.Tensor:
    """image: (..., H_i, W_i) flat gather at integer-cast uv (..., 2, H, W),
    matching ``int(u) + int(v) * image_width`` (custom_image_kernels.py:182)."""
    flat = image.flatten(-2)
    idx = uv[..., 0, :, :].to(torch.int64) + uv[..., 1, :, :].to(torch.int64) * int(image_width)
    idx = torch.clamp(idx, 0, flat.shape[-1] - 1)
    return torch.gather(flat, -1, idx.flatten(-2)).reshape(uv.shape[:-3] + uv.shape[-2:])


def image_fuse_replace(sem_layer, image_mono, uv, valid, image_width):
    """average_correspondences_to_map_kernel: direct replacement where valid."""
    vals = _gather_pixels(image_mono, uv, image_width)
    return torch.where(valid, vals, sem_layer)


def image_fuse_exponential(sem_layer, image_mono, uv, valid, image_width, alpha):
    vals = _gather_pixels(image_mono, uv, image_width)
    return torch.where(valid, sem_layer * (1 - alpha) + alpha * vals, sem_layer)


def image_fuse_color(sem_layer, image_rgb, uv, valid, image_width):
    """color_correspondences_to_map_kernel: pack rgb at uv into float bits.
    ``image_rgb`` is (..., 3, H_i, W_i)."""
    r = _gather_pixels(image_rgb[..., 0, :, :], uv, image_width)
    g = _gather_pixels(image_rgb[..., 1, :, :], uv, image_width)
    b = _gather_pixels(image_rgb[..., 2, :, :], uv, image_width)
    packed = uint_to_rgb_float(r.to(torch.int64), g.to(torch.int64), b.to(torch.int64))
    return torch.where(valid, packed, sem_layer)
