"""Plain PyTorch reference of the exact visibility cleanup: the per-ray
march of the upstream ``add_points_kernel``, dense, for a batch of maps.

The upstream kernel (``kernels/custom_kernels.py:198-259`` of
leggedrobotics/elevation_mapping_cupy) walks each point's ray from the
sensor in steps of res/sqrt(2) while the distance is below the ray's length
(at most ``max_ray_length``). A sample in the map's interior, in a cell the
previous step was not in and at least sqrt(0.1) from the point, reads the
cell: an invalid cell takes the sample's height as an upper-bound candidate
when it is below the cell's upper bound; a cell that is valid, not seen in
this update (time >= 0.5) and not a wall, which the sample penetrates
(height > sample + 0.01 - min(variance, 1) * 0.05) along a ray that is not
parallel to its surface (|ray . normal| >= cleanup_cos_thresh), loses
``cleanup_step / (ray_length / max_ray_length)`` of validity, gains
``outlier_variance`` of variance and takes the candidate too.

Here every (ray, step) sample is computed, in chunks of rays, with no gate
and no kernel: float32, TF32 off. It imports nothing of the program. Where
it departs from the upstream kernel, it does so as the port and the JAX
package do, so that the same inputs give the same cells:

- the step distances are a table, ``s_m = fl((m + 1) * fl(res / sqrt 2))``,
  not a running sum of steps;
- a sample's position ``t + d * s``, the squared distance to the point and
  the cosine are rounded as fused multiply-adds (:func:`fma`), in the order
  XLA contracts the JAX package's sums; the ray's norm is the correctly
  rounded root of such a sum;
- divisions are IEEE divisions (on the card PyTorch divides by a Python
  scalar as a reciprocal multiply, :func:`_div` avoids it);
- the decrement is summed per cell in chunk order, which differs from the
  program's atomics in the last bits.

``update`` and ``replay_episode`` are ``update.py``'s and ``replay.py``'s
with this march in place of the polar cleanup; every other stage is theirs,
imported.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from . import update as U
from .params import Params

__all__ = ["fma", "march", "cleanup", "update", "replay_episode"]

# samples of one chunk of the dense march: a (rays x steps) float32 tensor
# of this many elements is 64 MB
_CHUNK_SAMPLES = 1 << 24


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` of float32 values rounded once, as a fused multiply-add:
    the product is exact in float64; the float64 sum's own rounding error
    (TwoSum) decides, where that sum is even, a step to its odd neighbour
    (rounding to odd), so that the final rounding to float32 is the single
    correct one."""
    p = a.double() * torch.as_tensor(b, device=a.device).double()
    c = torch.as_tensor(c, device=a.device).double()
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    odd = (s.contiguous().view(torch.int64) & 1) == 1
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    s = torch.where((err != 0) & ~odd, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _cell_rows(layers: torch.Tensor, normal: torch.Tensor, inlier_cnt: torch.Tensor, p: Params) -> torch.Tensor:
    """(B * n * n, 7) what the march reads of each cell, from the map as the
    fusion left it: height, the penetration slack min(variance, 1) * 0.05,
    the upper bound a candidate must be below (+inf without one), the
    cell's kind (1 invalid, 2 may be cleaned up, 0 neither) and the normal."""
    b = layers.shape[0]
    L = layers.reshape(b, 7, -1)
    invalid = L[:, 2] < 0.5
    ok = ~invalid & (L[:, 4] >= 0.5) & ~((inlier_cnt.reshape(b, -1) > p.wall_num_thresh) & (L[:, 4] < 1.0))
    kind = torch.where(invalid, 1.0, torch.where(ok, 2.0, 0.0))
    rows = [L[:, 0], torch.clamp(L[:, 1], max=1.0) * 0.05, torch.where(L[:, 6] < 0.5, math.inf, L[:, 5]), kind]
    rows += list(normal.reshape(b, 3, -1).unbind(1))
    return torch.stack(rows, dim=-1).reshape(-1, 7)


def march(layers, normal, inlier_cnt, world, valid, t, p: Params):
    """The dense march of B maps: ``world`` (B, N, 3) the points in the
    map-centre frame, ``valid`` (B, N) the rays marched, ``t`` (B, 3) the
    sensor. Returns per cell (B, n * n) the summed validity decrement, the
    hit count and the lowest upper-bound candidate (+inf where none)."""
    b, n_rays = world.shape[:2]
    n, dev = p.cell_n, world.device
    rows = _cell_rows(layers, normal, inlier_cnt, p)
    dec = torch.zeros(b * n * n, dtype=torch.float32, device=dev)
    hits = torch.zeros_like(dec)
    ubmin = torch.full_like(dec, math.inf)
    n_steps = p.n_ray_steps
    if n_steps <= 0 or n_rays == 0:
        return dec.view(b, -1), hits.view(b, -1), ubmin.view(b, -1)
    step = torch.tensor(p.ray_step, dtype=torch.float32, device=dev)
    steps = torch.arange(1, n_steps + 1, dtype=torch.float32, device=dev) * step
    maps = torch.arange(b, device=dev).repeat_interleave(n_rays)
    pts, ok, ts = world.reshape(-1, 3), valid.reshape(-1), t[maps]
    chunk = max(1, _CHUNK_SAMPLES // n_steps)
    for lo in range(0, b * n_rays, chunk):
        hi = min(lo + chunk, b * n_rays)
        pe, tc, mc = pts[lo:hi], ts[lo:hi], maps[lo:hi]
        v = pe - tc
        norm = torch.sqrt(fma(v[:, 2], v[:, 2], fma(v[:, 1], v[:, 1], v[:, 0] * v[:, 0])).double()).float()
        d = torch.where(norm[:, None] > 0, v / torch.clamp(norm, min=1e-30)[:, None], 0.0)
        ray_length = torch.clamp(norm, max=p.max_ray_length)
        amount = torch.full_like(ray_length, p.cleanup_step) / _div(ray_length, p.max_ray_length)
        # every sample of the chunk: (rays, steps)
        sx, sy, sz = (fma(d[:, i, None], steps[None, :], tc[:, i, None]) for i in range(3))
        ix = torch.trunc(torch.clamp(_div(sx, p.resolution) + 0.5 * n, 0.0, n - 1)).to(torch.int64)
        iy = torch.trunc(torch.clamp(_div(sy, p.resolution) + 0.5 * n, 0.0, n - 1)).to(torch.int64)
        cell = n * ix + iy
        fresh = torch.ones_like(cell, dtype=torch.bool)
        fresh[:, 1:] = cell[:, 1:] != cell[:, :-1]
        ex, ey, ez = pe[:, 0, None] - sx, pe[:, 1, None] - sy, pe[:, 2, None] - sz
        far = fma(ez, ez, fma(ey, ey, ex * ex)) >= 0.1
        inside = (ix > 0) & (ix < n - 1) & (iy > 0) & (iy < n - 1)
        live = (steps[None, :] < ray_length[:, None]) & ok[lo:hi, None]
        r, m = torch.nonzero(live & fresh & inside & far, as_tuple=True)
        if r.numel() == 0:
            continue
        at = mc[r] * (n * n) + cell[r, m]
        row = rows[at]
        nz = sz[r, m]
        below = nz < row[:, 2]
        penetrates = row[:, 0] > nz + 0.01 - row[:, 1]
        cos = fma(d[r, 2], row[:, 6], fma(d[r, 0], row[:, 4], d[r, 1] * row[:, 5]))
        hit = (row[:, 3] == 2.0) & penetrates & (torch.abs(cos) >= p.cleanup_cos_thresh)
        candidate = ((row[:, 3] == 1.0) | hit) & below
        dec.index_add_(0, at[hit], amount[r[hit]])
        hits.index_add_(0, at[hit], torch.ones_like(nz[hit]))
        ubmin.scatter_reduce_(0, at[candidate], nz[candidate], reduce="amin")
    return dec.view(b, -1), hits.view(b, -1), ubmin.view(b, -1)


def cleanup(layers, normal, world, valid, inlier_cnt, t, p: Params) -> torch.Tensor:
    """The exact cleanup's result on the layers: validity lowered by the
    decrement, variance raised by the hits, upper bounds written where a
    candidate came."""
    if not p.enable_visibility_cleanup or p.n_ray_steps <= 0:
        return layers
    dec, hits, ubmin = march(layers, normal, inlier_cnt, world, valid, t, p)
    out = layers.reshape(*layers.shape[:2], -1).clone()
    out[:, 2] -= dec
    out[:, 1] += hits * p.outlier_variance
    wrote = torch.isfinite(ubmin)
    out[:, 5] = torch.where(wrote, ubmin, out[:, 5])
    out[:, 6] = torch.where(wrote, 1.0, out[:, 6])
    return out.reshape(layers.shape)


@torch.no_grad()
def update(st: U.State, points, pad_mask, R, t, position_noise, orientation_noise, w: U.Weights, p: Params,
           storage=torch.float32) -> U.State:
    """``update.update`` with the exact cleanup in place of the polar one."""
    if p.cleanup_mode() != "exact":
        raise NotImplementedError("this reference holds the exact cleanup only")
    dev = st.layers.device
    if storage != torch.float32:
        points = points.to(storage).float()
    position_noise = torch.as_tensor(position_noise, dtype=torch.float32, device=dev)
    orientation_noise = torch.as_tensor(orientation_noise, dtype=torch.float32, device=dev)
    t_c = t - st.center
    world, noise, j, valid, mask = U._associate(points, pad_mask, R, t_c, p)
    layers, newmap, inlier_cnt, mean_error, additive = U._fuse(
        st.layers, world, noise, j, mask, position_noise, orientation_noise, st.mean_error, st.additive, p)
    layers = cleanup(layers, st.normal, world, valid, inlier_cnt, t_c, p)
    layers = U._average(layers, newmap, p)
    if p.enable_overlap_clearance:
        layers = U._clear_overlap(layers, t_c, p)
    trav_in, _ = U._dilation_fill(layers[:, 5], layers[:, 2] + layers[:, 6], p.dilation_size)
    layers = layers.clone()
    layers[:, 3, 3:-3, 3:-3] = U._traversability(trav_in, w)
    normal = U._normals(trav_in, layers[:, 2], p.resolution)
    return U._store(U.State(layers, normal, st.center, mean_error, additive), storage)


@torch.no_grad()
def replay_episode(p: Params, weights: U.Weights, clouds: Sequence[torch.Tensor], base: Sequence[torch.Tensor],
                   sensor: Sequence[torch.Tensor], storage=torch.float32) -> U.State:
    """``replay.replay_episode`` with :func:`update`: a fresh batch of maps
    through one episode of the datagen traffic."""
    b, n = clouds[0].shape[:2]
    dev = clouds[0].device
    st = U.fresh(p, b, dev)
    R = torch.eye(3, device=dev).expand(b, 3, 3)
    mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    zero = torch.zeros((b,), device=dev)
    for pts, pos, t in zip(clouds, base, sensor):
        st = U.move_to(st, pos, p, storage)
        st = update(st, pts, mask, R, t, zero, zero, weights, p, storage)
    return st
