"""Plain PyTorch reference of the image path, for a batch of maps.

Written from the upstream kernels' semantics (``custom_image_kernels.py``),
not from the program, and importing nothing of it:

- ``image_to_map_correspondence_kernel`` (:9-157), one map cell at a time:
  the cell's point at its height, projected by P = K[R|t] and distorted by
  the radtan model; the front, image and height gates; then the Bresenham
  walk over the height map from the cell toward the camera's cell, which
  finds the cell occluded where a valid cell on the way stands more than
  ``tolerance_z_collision`` above the straight line from the cell to the
  camera. The walk here steps every cell of every map together through all
  2·cell_n steps a walk can take, with no early exit and nothing read back.
- ``color_correspondences_to_map_kernel`` and
  ``exponential_correspondences_to_map_kernel`` (:160-271): a visible
  cell takes the pixel at (int(u), int(v)), packed as ``0x00RRGGBB`` in a
  float's bits for a colour layer, or blended as ``layer · (1 − alpha) +
  alpha · pixel`` for an exponential one.

As the map moves, its semantic layers roll with its elevation layers and
the cells the move reveals are zeroed (``reference/update.py::move_to``).
Every tensor carries a leading batch axis of B maps; ``storage`` is the
dtype the layers are held in between steps, as in ``reference/update.py``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from . import update as U
from .params import Params
from .replay import TOL

__all__ = ["correspondence", "fuse", "move_to", "input_image", "replay_episode", "unpack_rgb",
           "semantic_mismatch"]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 root, on any device."""
    return torch.sqrt(x.double()).float()


def _projection(R: torch.Tensor, t: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """P = K [R | t] (B, 3, 4), formed in float64 and rounded to float32,
    as the upstream node forms it on the host."""
    return (K.double() @ torch.cat([R, t[:, :, None]], dim=-1).double()).float()


def _camera(R: torch.Tensor, t: torch.Tensor, center: torch.Tensor, p: Params) -> Tuple[torch.Tensor, ...]:
    """The camera's cell (row, column) and height in each map's frame."""
    pos = (-(R.double().transpose(1, 2) @ t.double()[:, :, None])[:, :, 0]).float() - center
    cell = torch.floor(p.cell_n / 2 + pos[:, :2] / torch.full((), p.resolution, device=pos.device))
    return cell[:, 0].to(torch.int64), cell[:, 1].to(torch.int64), pos[:, 2]


def _walk(h: torch.Tensor, ok: torch.Tensor, todo: torch.Tensor, x1: torch.Tensor, y1: torch.Tensor,
          cam_z: torch.Tensor, p: Params) -> torch.Tensor:
    """Occluded cells (B, n, n): the Bresenham walk of every cell in
    ``todo`` from itself toward the camera's cell (x1, y1), all 2·n steps;
    ``ok`` marks the cells whose height counts on the way."""
    n = p.cell_n
    b = h.shape[0]
    dev = h.device
    r = torch.arange(n, device=dev)
    x0 = r[None, :, None].expand(b, n, n)
    y0 = r[None, None, :].expand(b, n, n)
    x1, y1, cam_z = x1[:, None, None], y1[:, None, None], cam_z[:, None, None]
    dx, sx = torch.abs(x1 - x0), torch.where(x0 < x1, 1, -1)
    dy, sy = -torch.abs(y1 - y0), torch.where(y0 < y1, 1, -1)
    total = _sqrt(((x0 - x1) ** 2 + (y0 - y1) ** 2).float())
    delta_z = cam_z - h
    flat_h, flat_ok = h.reshape(b, n * n), ok.reshape(b, n * n)
    x, y, err = x0.clone(), y0.clone(), dx + dy
    active, occluded = todo.clone(), torch.zeros_like(todo)
    for _ in range(2 * n):
        active &= ~((x == x1) & (y == y1))
        inside = (x >= 0) & (x < n) & (y >= 0) & (y < n)
        at = (torch.clamp(x, 0, n - 1) * n + torch.clamp(y, 0, n - 1)).reshape(b, n * n)
        height = torch.gather(flat_h, 1, at).reshape(b, n, n)
        valid = torch.gather(flat_ok, 1, at).reshape(b, n, n)
        dis = _sqrt(((x - x0) ** 2 + (y - y0) ** 2).float())
        ray = h + torch.where(total > 0, dis / torch.where(total > 0, total, 1.0), 0.0) * delta_z
        hit = active & inside & valid & (height - p.tolerance_z_collision > ray)
        occluded |= hit
        active &= ~hit
        e2 = 2 * err
        step_x = active & (e2 >= dy)
        end_x = step_x & (x == x1)
        active &= ~end_x
        step_x &= ~end_x
        step_y = active & (e2 <= dx)
        end_y = step_y & (y == y1)
        active &= ~end_y
        step_y &= ~end_y
        err = err + torch.where(step_x, dy, 0) + torch.where(step_y, dx, 0)
        x = x + torch.where(step_x, sx, 0)
        y = y + torch.where(step_y, sy, 0)
    return occluded


def correspondence(st: U.State, R: torch.Tensor, t: torch.Tensor, K: torch.Tensor, D: torch.Tensor,
                   height: int, width: int, p: Params) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(u, v, visible), each (B, n, n): every cell's pixel in the image of
    its map's camera, and whether the camera sees the cell."""
    n = p.cell_n
    b, dev = st.layers.shape[0], st.layers.device
    h, ok = st.layers[:, 0], st.layers[:, 2] == 1.0
    r = torch.arange(n, device=dev, dtype=torch.float32)
    px = ((r - n / 2) * p.resolution)[None, :, None] + st.center[:, 0, None, None]
    py = ((r - n / 2) * p.resolution)[None, None, :] + st.center[:, 1, None, None]
    pz = h + st.center[:, 2, None, None]
    P = _projection(R, t, K)

    def row(i):
        return (px * P[:, i, 0, None, None] + py * P[:, i, 1, None, None] + pz * P[:, i, 2, None, None]
                + P[:, i, 3, None, None])

    u, v, d = row(0), row(1), row(2)
    front = d > 0
    u = u / torch.where(front, d, 1.0)
    v = v / torch.where(front, d, 1.0)
    k1, k2, p1, p2, k3 = (D[:, j, None, None] for j in range(5))
    fx, fy = K[:, 0, 0, None, None], K[:, 1, 1, None, None]
    cx, cy = K[:, 0, 2, None, None], K[:, 1, 2, None, None]
    xn, yn = (u - cx) / fx, (v - cy) / fy
    r2 = xn * xn + yn * yn
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + 2 * p2 * xn * yn + p1 * (r2 + 2 * yn * yn)
    plain = (D == 0).all(dim=1)[:, None, None]
    u = torch.where(plain, u, fx * xd + cx)
    v = torch.where(plain, v, fy * yd + cy)
    seen = ok & front & (u >= 0) & (v >= 0) & (u < width) & (v < height)
    x1, y1, cam_z = _camera(R, t, st.center, p)
    visible = seen & ~_walk(h, st.layers[:, 2] != 0, seen, x1, y1, cam_z, p)
    return torch.where(seen, u, 0.0), torch.where(seen, v, 0.0), visible


def _pixels(image: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, C, n, n): the image's planes (B, C, H, W) at pixel (int(u), int(v))."""
    b, c, hgt, wid = image.shape
    at = (u.to(torch.int64) + v.to(torch.int64) * wid).reshape(b, 1, -1).expand(b, c, -1)
    return torch.gather(image.reshape(b, c, hgt * wid), 2, torch.clamp(at, 0, hgt * wid - 1)).reshape(
        b, c, *u.shape[1:])


def fuse(sem: torch.Tensor, image: torch.Tensor, u, v, visible, channels: Sequence[str], p: Params) -> torch.Tensor:
    """The semantic layers (B, S, n, n) after one image (B, planes, H, W)
    whose planes follow ``channels``: ``rgb`` three, every other one."""
    fusions = dict((k, f) for k, f in p.image_channel_fusions)
    out = sem.clone()
    plane = 0
    for ch in channels:
        layer = p.semantic_layers.index(ch)
        fusion = fusions.get(ch, fusions.get("default"))
        if fusion == "color":
            rgb = _pixels(image[:, plane:plane + 3], u, v).to(torch.int64)
            packed = ((rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]).to(torch.int32).view(torch.float32)
            out[:, layer] = torch.where(visible, packed, sem[:, layer])
        elif fusion == "exponential":
            pixel = _pixels(image[:, plane:plane + 1], u, v)[:, 0]
            alpha = p.image_exponential_alpha
            out[:, layer] = torch.where(visible, sem[:, layer] * (1 - alpha) + alpha * pixel, sem[:, layer])
        else:
            raise ValueError(f"no reference of the image fusion {fusion!r}")
        plane += 3 if ch == "rgb" else 1
    return out


def move_to(st: U.State, sem: torch.Tensor, position: torch.Tensor, p: Params,
            storage=torch.float32) -> Tuple[U.State, torch.Tensor]:
    """``reference/update.py::move_to`` with the semantic layers rolled by
    the same whole-cell shift and the revealed cells zeroed."""
    shift = torch.round(U._div(position[:, :2] - st.center[:, :2], p.resolution))
    n = p.cell_n
    r = torch.arange(n, device=sem.device)
    out = []
    for b, (s0, s1) in enumerate((-shift).to(torch.int64).tolist()):
        rev = ((r < s0) if s0 > 0 else (r >= n + s0))[:, None] | ((r < s1) if s1 > 0 else (r >= n + s1))[None, :]
        out.append(torch.where(rev, 0.0, torch.roll(sem[b], (s0, s1), dims=(-2, -1))))
    return U.move_to(st, position, p, storage), _store(torch.stack(out), storage)


def _store(sem: torch.Tensor, storage) -> torch.Tensor:
    return sem if storage == torch.float32 else sem.to(storage).to(torch.float32)


@torch.no_grad()
def input_image(st: U.State, sem: torch.Tensor, image: torch.Tensor, R, t, K, D, channels: Sequence[str],
                p: Params, storage=torch.float32) -> torch.Tensor:
    """The semantic layers after each map's camera image."""
    u, v, visible = correspondence(st, R, t, K, D, image.shape[-2], image.shape[-1], p)
    return _store(fuse(sem, image, u, v, visible, channels, p), storage)


@torch.no_grad()
def replay_episode(p: Params, weights: U.Weights, clouds: Sequence[torch.Tensor], base: Sequence[torch.Tensor],
                   sensor: Sequence[torch.Tensor], images: Sequence[torch.Tensor], Rc: Sequence[torch.Tensor],
                   tc: Sequence[torch.Tensor], K: torch.Tensor, D: torch.Tensor, channels: Sequence[str],
                   storage=torch.float32) -> Tuple[U.State, torch.Tensor]:
    """A fresh batch of maps through one episode of the multi-modal
    traffic: per step the move to the robot's ``base``, the update with the
    depth cloud (``reference/replay.py::replay_episode``), then the image of
    each map's camera (world to optical frame ``Rc``, ``tc``)."""
    b, n = clouds[0].shape[:2]
    dev = clouds[0].device
    st = U.fresh(p, b, dev)
    sem = torch.zeros((b, len(p.semantic_layers), p.cell_n, p.cell_n), device=dev)
    eye = torch.eye(3, device=dev).expand(b, 3, 3)
    mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    zero = torch.zeros((b,), device=dev)
    for s in range(len(clouds)):
        st, sem = move_to(st, sem, base[s], p, storage)
        st = U.update(st, clouds[s], mask, eye, sensor[s], zero, zero, weights, p, storage)
        sem = input_image(st, sem, images[s], Rc[s], tc[s], K, D, channels, p, storage)
    return st, sem


def unpack_rgb(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) the red, green and blue of colours packed in floats' bits."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.stack([(bits >> 16) & 0xFF, (bits >> 8) & 0xFF, bits & 0xFF], dim=-1)


def semantic_mismatch(got: torch.Tensor, want: torch.Tensor, p: Params) -> Tuple[Dict[str, float], float]:
    """(per layer, over all layers) the share of the semantic layers' cells
    (B, S, n, n) that disagree: a colour layer's cells unless their red,
    green and blue are equal, any other's where |got − want| > TOL ·
    max(1, |want|)."""
    got = got.to(want.device)
    fusions = dict((k, f) for k, f in p.image_channel_fusions)
    off: List[torch.Tensor] = []
    shares = {}
    for i, name in enumerate(p.semantic_layers):
        if fusions.get(name, fusions.get("default")) == "color":
            bad = (unpack_rgb(got[:, i]) != unpack_rgb(want[:, i])).any(dim=-1)
        else:
            close = torch.abs(got[:, i] - want[:, i]) <= TOL * torch.clamp(torch.abs(want[:, i]), min=1.0)
            bad = ~(close | (torch.isnan(got[:, i]) & torch.isnan(want[:, i])))
        shares[name] = float(bad.float().mean())
        off.append(bad)
    return shares, float(torch.stack(off).float().mean()) if off else 0.0
