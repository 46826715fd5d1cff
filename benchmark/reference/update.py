"""Plain PyTorch reference of one geometric map update, for a batch of maps.

A frozen copy of ``elevation_mapping_cupy_torch``'s update path as it runs
without kernels (``core.update_batch_aux`` with the polar visibility
cleanup), with every hand-written kernel replaced by its plain version:
K1's point-to-cell scatter-add is one ``index_add_``. It imports nothing of
the program; it reads only the benchmark's inputs and its configuration.
Stages, in the order of the upstream ``update_map_with_kernel``: point
association, error counting and drift compensation, Kalman fusion, the
polar visibility cleanup, averaging, overlap clearance, dilation, the
traversability CNN and the normals; then the map's motion and timers.

Every tensor carries a leading batch axis of B maps. ``storage`` is the
dtype the map is held in between steps: float32, as the configuration
states, or a lower one for the control that shows the comparison fails a
lower precision (the arithmetic stays float32).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .params import Params

__all__ = ["State", "Weights", "fresh", "update", "move_to", "update_variance", "update_time", "export", "LAYERS"]

# layer stack: 0 elevation, 1 variance, 2 is_valid, 3 traversability,
# 4 time, 5 upper_bound, 6 is_upper_bound
LAYERS = ("elevation", "variance", "is_valid", "traversability", "time", "upper_bound", "is_upper_bound")
_NORMALS = ("normal_x", "normal_y", "normal_z")
# bytes of one (maps x cells x S) float32 tensor of the polar evaluation: a
# larger batch is evaluated in chunks of maps, so that the reference fits
_EVAL_BYTES = 1 << 29


class State(NamedTuple):
    layers: torch.Tensor        # (B, 7, n, n)
    normal: torch.Tensor        # (B, 3, n, n)
    center: torch.Tensor        # (B, 3)
    mean_error: torch.Tensor    # (B,)
    additive: torch.Tensor      # (B,)


class Weights(NamedTuple):
    """The traversability CNN's four weight arrays (OIHW)."""

    w1: torch.Tensor
    w2: torch.Tensor
    w3: torch.Tensor
    w_out: torch.Tensor

    @staticmethod
    def from_arrays(arrays, device) -> "Weights":
        return Weights(*(torch.as_tensor(np.asarray(arrays[k], np.float32), device=device)
                         for k in ("w1", "w2", "w3", "w_out")))


def fresh(p: Params, batch: int, device) -> State:
    n = p.cell_n
    layers = torch.zeros((batch, 7, n, n), dtype=torch.float32, device=device)
    layers[:, 1] = p.initial_variance
    layers[:, 3] = 1.0
    z = torch.zeros((batch,), dtype=torch.float32, device=device)
    return State(layers, torch.zeros((batch, 3, n, n), device=device), torch.zeros((batch, 3), device=device), z, z.clone())


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """One IEEE division by ``c`` (a CUDA division by a Python scalar is a
    multiplication by its reciprocal, which rounds apart by an ulp)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _scatter_add(idx: torch.Tensor, mask: torch.Tensor, streams, n_cells: int) -> torch.Tensor:
    """Sum of each (B, N) value stream into (B, K, n_cells) cells, masked
    points left out: one ``index_add_``."""
    b, n = idx.shape
    k = len(streams)
    vals = torch.stack([s.to(torch.float32) for s in streams], dim=1)
    keep = mask & (idx >= 0) & (idx < n_cells)
    safe = torch.where(keep, idx, 0).long()
    base = (torch.arange(b * k, device=idx.device) * n_cells).view(b, k, 1)
    out = torch.zeros(b * k * n_cells, dtype=torch.float32, device=idx.device)
    out.index_add_(0, (base + safe[:, None, :]).reshape(-1), torch.where(keep[:, None, :], vals, 0.0).reshape(-1))
    return out.view(b, k, n_cells)


def _gather(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(flat, -1, idx.long())


# ---------------------------------------------------------------------------
# association
# ---------------------------------------------------------------------------

def _associate(points, pad_mask, R, t, p: Params):
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    world = torch.stack([R[:, i, 0, None] * x + R[:, i, 1, None] * y + R[:, i, 2, None] * z + t[:, i, None]
                         for i in range(3)], dim=-1)
    noise = p.sensor_noise_factor * z * z
    n = p.cell_n

    def axis(c):
        f = _div(c, p.resolution) + 0.5 * n
        return torch.trunc(torch.clamp(f, 0.0, n - 1)).to(torch.int32)

    ix, iy = axis(world[..., 0]), axis(world[..., 1])
    wx, wy, wz = world[..., 0], world[..., 1], world[..., 2]
    d2 = torch.sum((world - t[:, None, :]) ** 2, dim=-1)
    dxy = torch.clamp(torch.sqrt(wx * wx + wy * wy) - p.ramped_height_range_b, min=0.0)
    tz = t[:, 2, None]
    valid = ~((d2 < p.min_valid_distance ** 2)
              | ((wz - tz) > (dxy * p.ramped_height_range_a + p.ramped_height_range_c))
              | ((wz - tz) > p.max_height_range)) & pad_mask
    inside = (ix > 0) & (ix < n - 1) & (iy > 0) & (iy < n - 1)
    return world, noise, n * ix + iy, valid, valid & inside & pad_mask


# ---------------------------------------------------------------------------
# fusion
# ---------------------------------------------------------------------------

def _fuse(layers, world, noise, j, mask, position_noise, orientation_noise, mean_prev, add_prev, p: Params):
    """Error counting, drift compensation and the Kalman fusion. Returns
    (layers, newmap (B, 3, n, n), inlier counts, mean error, additive)."""
    b, _, h, w = layers.shape
    rows = torch.gather(layers.flatten(-2).transpose(-1, -2), -2, j.long()[..., None].expand(*j.shape, 7))
    map_h, map_v, map_valid, map_t = rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3]
    z = world[..., 2]
    inlier = (mask & (map_valid > 0.5) & (torch.abs(map_h - z) < map_v * p.mahalanobis_thresh)
              & (map_v < p.drift_compensation_variance_inlier / 2.0) & (map_t > p.traversability_inlier))
    sums = _scatter_add(j, mask, [inlier, mask], h * w)
    inlier_cnt, point_cnt = sums[:, 0], sums[:, 1]
    error_sum = torch.sum(torch.where(inlier, z - map_h, 0.0), dim=-1)
    error_cnt = torch.sum(inlier, dim=-1)

    delta = torch.zeros_like(mean_prev)
    mean_error, additive = mean_prev, add_prev
    if p.enable_drift_compensation:
        gate = (error_cnt > p.min_height_drift_cnt) & (
            (position_noise > p.position_noise_thresh) | (orientation_noise > p.orientation_noise_thresh))
        new_mean = error_sum / torch.clamp(error_cnt, min=1).to(torch.float32)
        mean_error = torch.where(gate, new_mean, mean_prev)
        additive = torch.where(gate, add_prev + new_mean, add_prev)
        delta = torch.where(gate & (torch.abs(new_mean) < p.max_drift), new_mean * p.drift_compensation_alpha, 0.0)
        layers = layers.clone()
        layers[:, 0] += delta[:, None, None]

    map_h = map_h + delta[:, None]
    pc = _gather(point_cnt, j)
    outlier = mask & (torch.abs(map_h - z) > map_v * p.mahalanobis_thresh)
    edge_skip = torch.zeros_like(outlier)
    if p.enable_edge_sharpen:
        edge_skip = (pc > p.wall_num_thresh) & (z < map_h - map_v * p.mahalanobis_thresh / torch.clamp(pc, min=1e-12))
    fuse = mask & ~outlier & ~edge_skip
    new_h = (map_h * noise + z * map_v) / (map_v + noise)
    new_v = (map_v * noise) / (map_v + noise)
    s = _scatter_add(j, fuse | outlier, [torch.where(fuse, new_h, 0.0), torch.where(fuse, new_v, 0.0), fuse, outlier], h * w)
    has = s[:, 2] > 0
    flat = layers.flatten(-2).clone()
    flat[:, 1] += s[:, 3] * p.outlier_variance
    flat[:, 2] = torch.where(has, 1.0, flat[:, 2])
    flat[:, 4] = torch.where(has, 0.0, flat[:, 4])
    flat[:, 5] = torch.where(has, s[:, 0] / torch.clamp(s[:, 2], min=1.0), flat[:, 5])
    flat[:, 6] = torch.where(has, 0.0, flat[:, 6])
    newmap = s[:, :3].reshape(b, 3, h, w)
    return flat.reshape(layers.shape), newmap, inlier_cnt.reshape(b, h, w), mean_error, additive


def _average(layers, newmap, p: Params):
    sum_h, sum_v, cnt = newmap.unbind(1)
    has = cnt > 0
    safe = torch.clamp(cnt, min=1.0)
    overflow = has & ((sum_v / safe) > p.max_variance)
    ok = has & ~overflow
    hgt = torch.where(ok, sum_h / safe, torch.where(overflow, 0.0, layers[:, 0]))
    var = torch.where(ok, sum_v / safe, torch.where(overflow, p.initial_variance, layers[:, 1]))
    val = torch.where(ok, 1.0, torch.where(overflow, 0.0, layers[:, 2]))
    reset = layers[:, 2] < 0.5
    out = layers.clone()
    out[:, 0] = torch.where(reset, 0.0, hgt)
    out[:, 1] = torch.where(reset, p.initial_variance, var)
    out[:, 2] = torch.where(reset, 0.0, val)
    return out


def _clear_overlap(layers, t, p: Params):
    lo, hi = p.overlap_cell_range
    tz = t[:, 2, None, None]
    hmin, hmax = tz - p.overlap_clear_range_z, tz + p.overlap_clear_range_z
    out = layers.clone()
    near = out[..., lo:hi, lo:hi]
    ok = ~((near[:, 0] < hmin) | (near[:, 0] > hmax))
    near[:, 0] = torch.where(ok, near[:, 0], 0.0)
    near[:, 1] = torch.where(ok, near[:, 1], p.initial_variance)
    near[:, 2] = torch.where(ok, near[:, 2], 0.0)
    ok5 = ~((near[:, 5] < hmin) | (near[:, 5] > hmax))
    near[:, 5] = torch.where(ok5, near[:, 5], 0.0)
    near[:, 6] = torch.where(ok5, near[:, 6], 0.0)
    return out


# ---------------------------------------------------------------------------
# polar visibility cleanup
# ---------------------------------------------------------------------------

def _bin(x, hi: int, rounding: bool = False):
    x = torch.clamp(x, 0.0, float(hi))
    return (torch.round(x) if rounding else x).to(torch.int32)


def _rows(table, idx):
    return torch.gather(table, 1, idx.long()[:, :, None].expand(-1, -1, table.shape[-1]))


def _cleanup(layers, normal, world, valid, inlier_cnt, t, p: Params):
    """Shadow-cube cleanup: rays binned into an (azimuth, radius, elevation)
    cube of {count, sum 1/length}, suffix sums along the radius, prefix sums
    along the azimuth, and each cell's penetration test over the elevation
    buckets of its azimuth window."""
    if not p.enable_visibility_cleanup or p.n_ray_steps <= 0:
        return layers
    if p.cleanup_mode() != "polar":
        raise NotImplementedError("the reference holds the polar cleanup only")
    if not p.raycast_slope_from_bins:
        raise NotImplementedError("the reference holds the bucket-slope upper bound only")
    A, S, R = p.azimuth_bins, p.raycast_elevation_bins, p.n_ray_steps + 2
    nb = layers.shape[0]
    v = world - t[:, None, :]
    len_xy = torch.sqrt(v[..., 0] ** 2 + v[..., 1] ** 2)
    len3d = torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1), min=1e-30))
    phi = torch.atan2(v[..., 2], len_xy)
    az = torch.atan2(v[..., 1], v[..., 0])
    a_idx = _bin((az + math.pi) * (A / (2.0 * math.pi)), A - 1)
    s_idx = _bin((phi + math.pi / 2) * (S / math.pi), S - 1)
    ray_len = torch.clamp(len3d, max=p.max_ray_length)
    s_max = torch.minimum(len3d - math.sqrt(0.1), ray_len)
    r_act = torch.cos(phi) * s_max
    r_idx = _bin(_div(r_act, p.ray_step), R - 1, rounding=True)
    active = valid & (r_act > 0) & (len3d > 0)
    cube_idx = (a_idx * R + r_idx) * S + s_idx
    inv_len = 1.0 / torch.clamp(ray_len, min=1e-30)
    cubes = _scatter_add(cube_idx, active, [torch.ones_like(inv_len), inv_len], A * R * S).reshape(nb, 2, A, R, S)
    packed = torch.cat([torch.flip(torch.cumsum(torch.flip(cubes[:, i], [2]), dim=2), [2]) for i in range(2)], dim=-1)
    del cubes
    pref = torch.cumsum(packed, dim=1)
    del packed
    total = pref[:, -1]
    chunk = max(1, min(nb, _EVAL_BYTES // (p.cell_n * p.cell_n * S * 4)))
    return torch.cat([
        _evaluate(layers[b:b + chunk], normal[b:b + chunk], inlier_cnt[b:b + chunk], t[b:b + chunk],
                  pref[b:b + chunk].reshape(-1, A * R, 2 * S), total[b:b + chunk], p)
        for b in range(0, nb, chunk)
    ])


def _evaluate(layers, normal, inlier_cnt, t, pref_flat, total, p: Params):
    A, S, R = p.azimuth_bins, p.raycast_elevation_bins, p.n_ray_steps + 2
    n, step, dev = p.cell_n, p.ray_step, layers.device
    two_pi = 2.0 * math.pi
    tx, ty, tz = (t[:, i, None] for i in range(3))
    i = torch.arange(n * n, dtype=torch.int32, device=dev)
    row_i, col_i = i // n, i % n
    cx = (row_i.float() + 0.5 - 0.5 * n) * p.resolution - tx
    cy = (col_i.float() + 0.5 - 0.5 * n) * p.resolution - ty
    r_c = torch.sqrt(cx * cx + cy * cy)
    a_c = torch.atan2(cy, cx)
    ai = _bin((a_c + math.pi) * (A / two_pi), A - 1)
    ri = _bin(_div(r_c, step), R - 1, rounding=True)
    in_range = (r_c <= p.max_ray_length) & (r_c >= step * 0.5)
    abs_c, abs_s = torch.abs(torch.cos(a_c)), torch.abs(torch.sin(a_c))
    band = p.resolution * (abs_c + abs_s)
    hw = _bin(torch.atan2(0.5 * band, torch.clamp(r_c, min=1e-6)) * (A / two_pi), A // 2 - 1)
    lo, hi = ai - hw, ai + hw
    hi_rows = _rows(pref_flat, (hi % A) * R + ri)
    lo_rows = torch.where(((lo % A) == 0)[..., None], 0.0, _rows(pref_flat, ((lo - 1) % A) * R + ri))
    tot_rows = _rows(total, ri)
    wrapped = (lo % A) > (hi % A)
    sums = torch.where(wrapped[..., None], tot_rows - (lo_rows - hi_rows), hi_rows - lo_rows)
    del hi_rows, lo_rows, tot_rows
    cnt_k, inv_k = sums[..., :S], sums[..., S:]

    flat = layers.flatten(-2)
    cell_h, cell_v, cell_valid, cell_t, cell_ub, cell_iub = (flat[:, k] for k in (0, 1, 2, 4, 5, 6))
    nrm = normal.flatten(-2)
    ic = inlier_cnt.flatten(-2)
    inside = (row_i > 0) & (row_i < n - 1) & (col_i > 0) & (col_i < n - 1)
    phi_k = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) * (math.pi / S) - math.pi / 2
    tan_k, cos_pk, sin_pk = torch.tan(phi_k), torch.cos(phi_k), torch.sin(phi_k)
    safe_r = torch.clamp(r_c, min=1e-6)
    delta_k = step * cos_pk
    mean_chord = p.resolution ** 2 / torch.clamp(band, min=1e-9)
    r_eval = torch.clamp(safe_r[..., None] - 0.5 * mean_chord[..., None] + 0.5 * delta_k, min=1e-6)
    s_star = cell_h - 0.01 + torch.clamp(cell_v, max=1.0) * 0.05 - tz
    pen_k = tan_k * r_eval < s_star[..., None]
    g_c = torch.cos(a_c) * nrm[:, 0] + torch.sin(a_c) * nrm[:, 1]
    cos_ok = torch.abs(g_c[..., None] * cos_pk + nrm[:, 2, :, None] * sin_pk) >= p.cleanup_cos_thresh
    mx = torch.maximum(abs_c, abs_s)
    w_lin = band[..., None] - delta_k * (abs_c * abs_s)[..., None]
    w_sat = (p.resolution ** 2) / torch.clamp(delta_k, min=1e-9)
    use_sat = delta_k >= (p.resolution / torch.clamp(mx, min=1e-9))[..., None]
    accept_k = torch.clamp(torch.where(use_sat, w_sat, w_lin) / torch.clamp(band[..., None], min=1e-9), 0.0, 1.0)
    has_rays = cnt_k > 0.5
    is_invalid = cell_valid < 0.5
    cell_gate = in_range & inside & ~is_invalid & (cell_t >= 0.5) & ~((ic > p.wall_num_thresh) & (cell_t < 1.0))
    hit_k = has_rays & pen_k & cos_ok & cell_gate[..., None]
    dec = p.cleanup_step * p.max_ray_length * torch.sum(torch.where(hit_k, inv_k * accept_k, 0.0), dim=-1)
    var = p.outlier_variance * torch.sum(torch.where(hit_k, cnt_k * accept_k, 0.0), dim=-1)
    nz_k = tz[..., None] + r_eval * tan_k
    ub_ok = (cell_iub[..., None] < 0.5) | (nz_k < cell_ub[..., None])
    cand = ((in_range & inside & is_invalid)[..., None] & has_rays & ub_ok) | (hit_k & ub_ok)
    ubmin = torch.amin(torch.where(cand, nz_k, math.inf), dim=-1)
    wrote = torch.isfinite(ubmin)
    out = flat.clone()
    out[:, 2] -= dec
    out[:, 1] += var
    out[:, 5] = torch.where(wrote, ubmin, out[:, 5])
    out[:, 6] = torch.where(wrote, 1.0, out[:, 6])
    return out.reshape(layers.shape)


# ---------------------------------------------------------------------------
# stencils and the CNN
# ---------------------------------------------------------------------------

def _neighbor_ok(n: int, dy: int, dx: int, device) -> torch.Tensor:
    """Whether each cell's flat neighbour ``n * dy + dx`` lies in the map
    and is interior (past a row's end the flat index goes on at the next
    row, as the upstream kernel's does)."""
    r = torch.arange(n, device=device)
    j = (r[:, None] + dy) * n + (r[None, :] + dx)
    jc = torch.clamp(j, 0, n * n - 1)
    jx, jy = jc // n, jc % n
    return (j >= 0) & (j < n * n) & (jx > 0) & (jx < n - 1) & (jy > 0) & (jy < n - 1)


def _dilation_fill(height, mask, size: int):
    """Fill invalid cells from the flat neighbour with the least dx + dy
    (ties: scan order)."""
    n = height.shape[-1]
    flat_h, flat_m = height.flatten(-2), mask.flatten(-2)
    pad = (size + 1) * n + size
    ph = F.pad(flat_h, (pad, pad))
    pm = F.pad(flat_m, (pad, pad))
    best_d = torch.full_like(flat_h, 100.0)
    best_v = torch.zeros_like(flat_h)
    for dy in range(-size, size + 1):
        for dx in range(-size, size + 1):
            off = pad + n * dy + dx
            nh, nm = ph[..., off:off + n * n], pm[..., off:off + n * n]
            ok = _neighbor_ok(n, dy, dx, height.device).reshape(-1)
            cand = ok & (nm > 0.5) & ((dx + dy) < best_d)
            best_d = torch.where(cand, float(dx + dy), best_d)
            best_v = torch.where(cand, nh, best_v)
    found = (flat_m < 0.5) & (best_d < 100.0)
    return (torch.where(found, best_v, flat_h).reshape(height.shape),
            torch.where(found, 1.0, flat_m).reshape(mask.shape))


def _normals(height, mask, resolution: float):
    n = height.shape[-1]
    hx = F.pad(height[..., :, 1:], (0, 1))
    hy = F.pad(height[..., 1:, :], (0, 0, 0, 1))
    ok = (mask > 0.5) & _neighbor_ok(n, 0, 1, height.device) & _neighbor_ok(n, 1, 0, height.device)
    nx = -(hy - height) / resolution
    ny = -(hx - height) / resolution
    norm = torch.sqrt(nx * nx + ny * ny + 1.0)
    return torch.where(ok[..., None, :, :], torch.stack([nx / norm, ny / norm, 1.0 / norm], dim=-3), 0.0)


def _traversability(x, w: Weights):
    """3 dilated 3x3 convolutions, |.|, a 1x1 head and exp(-x), in float32
    (TF32 off)."""
    b, h, wd = x.shape
    x = x.reshape(b, 1, h, wd)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        o1 = F.conv2d(x, w.w1, dilation=1)[:, :, 2:-2, 2:-2]
        o2 = F.conv2d(x, w.w2, dilation=2)[:, :, 1:-1, 1:-1]
        o3 = F.conv2d(x, w.w3, dilation=3)
        out = F.conv2d(torch.abs(torch.cat([o1, o2, o3], dim=1)), w.w_out)
    return torch.exp(-out).reshape(b, h - 6, wd - 6)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def _store(st: State, storage) -> State:
    """The state as the map holds it between steps."""
    if storage == torch.float32:
        return st
    return st._replace(layers=st.layers.to(storage).float(), normal=st.normal.to(storage).float())


@torch.no_grad()
def update(st: State, points, pad_mask, R, t, position_noise, orientation_noise, w: Weights, p: Params,
           storage=torch.float32) -> State:
    """One pointcloud update of B maps: points (B, N, 3) in the sensor
    frame, pad_mask (B, N), R (B, 3, 3), t (B, 3) in the world, the noise
    values one per map."""
    dev = st.layers.device
    if storage != torch.float32:
        points = points.to(storage).float()
    position_noise = torch.as_tensor(position_noise, dtype=torch.float32, device=dev)
    orientation_noise = torch.as_tensor(orientation_noise, dtype=torch.float32, device=dev)
    t_c = t - st.center
    world, noise, j, valid, mask = _associate(points, pad_mask, R, t_c, p)
    layers, newmap, inlier_cnt, mean_error, additive = _fuse(
        st.layers, world, noise, j, mask, position_noise, orientation_noise, st.mean_error, st.additive, p)
    layers = _cleanup(layers, st.normal, world, valid, inlier_cnt, t_c, p)
    layers = _average(layers, newmap, p)
    if p.enable_overlap_clearance:
        layers = _clear_overlap(layers, t_c, p)
    trav_in, _ = _dilation_fill(layers[:, 5], layers[:, 2] + layers[:, 6], p.dilation_size)
    layers = layers.clone()
    layers[:, 3, 3:-3, 3:-3] = _traversability(trav_in, w)
    normal = _normals(trav_in, layers[:, 2], p.resolution)
    return _store(State(layers, normal, st.center, mean_error, additive), storage)


@torch.no_grad()
def move_to(st: State, position: torch.Tensor, p: Params, storage=torch.float32) -> State:
    """Recentre each map on ``position`` (B, 3): a whole-cell roll of the
    layer stack (the normals stay where they are until the next update
    writes them), the revealed cells reset, heights shifted by the vertical
    move."""
    delta = position - st.center
    shift = torch.round(_div(delta[:, :2], p.resolution))
    center = st.center.clone()
    center[:, :2] += shift * p.resolution
    center[:, 2] += delta[:, 2]
    n = p.cell_n
    r = torch.arange(n, device=st.layers.device)
    layers = []
    for b, (s0, s1) in enumerate((-shift).to(torch.int64).tolist()):
        rev = ((r < s0) if s0 > 0 else (r >= n + s0))[:, None] | ((r < s1) if s1 > 0 else (r >= n + s1))[None, :]
        rolled = torch.roll(st.layers[b], (s0, s1), dims=(-2, -1))
        lay = torch.where(rev, 0.0, rolled)
        lay[1] = torch.where(rev, p.initial_variance, rolled[1])
        lay[0] -= delta[b, 2]
        lay[5] -= delta[b, 2]
        layers.append(lay)
    return _store(st._replace(layers=torch.stack(layers), center=center), storage)


@torch.no_grad()
def update_variance(st: State, p: Params, storage=torch.float32) -> State:
    layers = st.layers.clone()
    layers[:, 1] += p.time_variance * st.layers[:, 2]
    return _store(st._replace(layers=layers), storage)


@torch.no_grad()
def update_time(st: State, p: Params, storage=torch.float32) -> State:
    layers = st.layers.clone()
    layers[:, 4] += p.time_interval
    return _store(st._replace(layers=layers), storage)


def export(st: State, b: int, name: str, p: Params) -> torch.Tensor:
    """Map ``b``'s layer ``name`` as a publisher hands it out: the border
    cropped, NaN where the layer says nothing, heights in the world frame,
    both axes flipped."""
    L = st.layers[b]
    nan = torch.full_like(L[0], math.nan)
    if name == "traversability":
        buf = nan.clone()
        buf[3:-3, 3:-3] = torch.where((L[2] + L[6]) > 0.5, L[3], nan)[3:-3, 3:-3]
        m = buf[1:-1, 1:-1]
    elif name in ("upper_bound", "is_upper_bound"):
        if p.use_only_above_for_upper_bound:
            ok = ((L[5] > 0.0) & (L[6] > 0.5)) | (L[2] > 0.5)
        else:
            ok = (L[2] > 0.5) | (L[6] > 0.5)
        m = torch.where(ok, L[5] if name == "upper_bound" else L[6], nan)[1:-1, 1:-1]
        if name == "upper_bound":
            m = m + st.center[b, 2]
    elif name == "elevation":
        m = torch.where(L[2] > 0.5, L[0], nan)[1:-1, 1:-1] + st.center[b, 2]
    elif name in LAYERS:
        m = L[LAYERS.index(name)][1:-1, 1:-1]
    elif name in _NORMALS:
        m = st.normal[b, _NORMALS.index(name)][1:-1, 1:-1]
    else:
        raise KeyError(name)
    return torch.flip(m, dims=(0, 1))


def layer_stack(st: State, b: int) -> Tuple[Tuple[str, ...], torch.Tensor]:
    """Every map-shaped field of map ``b``, uncropped: (names, (10, n, n))."""
    return LAYERS + _NORMALS, torch.cat([st.layers[b], st.normal[b]])
