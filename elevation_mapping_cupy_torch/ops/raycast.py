"""Ray-cast visibility cleanup: the polar shadow-cube formulation.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/ops/raycast.py``:
``resolve_raycast_mode``, the ``visibility_cleanup`` dispatcher and
``visibility_cleanup_polar``. The exact per-step march (the JAX package's
``visibility_cleanup_exact``) is slice 2 of the port (ROADMAP.md, queue A)
and raises here.

Race resolutions R1 (snapshot reads) and R3 (min-height upper-bound write)
per tests/golden/reference_numpy.py.
"""

from __future__ import annotations

import math

import torch

from ..config import MapConfig
from . import scatter
from .geometry import PointAssociation, true_div

__all__ = [
    "visibility_cleanup",
    "visibility_cleanup_polar",
    "resolve_raycast_mode",
]

# `auto` picks the exact march only when it is at most this many steps and
# its work, times this ratio, is below the cube's (the JAX package's
# defaults for the same decision, raycast.py:54-55)
_AUTO_MAX_STEPS = 12
_AUTO_WORK_RATIO = 8


def resolve_raycast_mode(cfg: MapConfig) -> str:
    """Static resolution of cfg.raycast_mode's "auto": the exact march only
    for short-ray configs whose march is much smaller than the shadow cube,
    polar otherwise (as in the JAX package, so both resolve alike)."""
    mode = cfg.raycast_mode
    if mode != "auto":
        return mode
    cube = cfg.azimuth_bins * (cfg.n_ray_steps + 2) * cfg.raycast_elevation_bins
    march = cfg.n_ray_steps * cfg.max_points
    return (
        "exact"
        if (cfg.n_ray_steps <= _AUTO_MAX_STEPS and march * _AUTO_WORK_RATIO < cube)
        else "polar"
    )


def visibility_cleanup(
    layers: torch.Tensor,
    normal: torch.Tensor,
    assoc: PointAssociation,
    inlier_cnt: torch.Tensor,
    t: torch.Tensor,
    cfg: MapConfig,
) -> torch.Tensor:
    """Dispatch on cfg.raycast_mode ("polar" / "exact" / "auto")."""
    if not cfg.enable_visibility_cleanup or cfg.n_ray_steps <= 0:
        return layers
    mode = resolve_raycast_mode(cfg)
    if mode == "polar":
        return visibility_cleanup_polar(layers, normal, assoc, inlier_cnt, t, cfg)
    if mode == "exact":
        raise NotImplementedError(
            "raycast_mode 'exact' (the per-step ray march) is not ported yet: it is "
            "slice 2 of ROADMAP.md queue A; use raycast_mode='polar'"
        )
    raise ValueError(f"unknown raycast_mode {cfg.raycast_mode!r}")


def _bin(x: torch.Tensor, hi: int, rounding: bool = False) -> torch.Tensor:
    """Float -> int32 bin index in [0, hi]: truncation toward zero (or
    round-half-even), clamped first because a cast of an out-of-range float
    is undefined. For in-range values this equals the JAX package's
    clip(cast(x)) (XLA's cast saturates)."""
    x = torch.clamp(x, 0.0, float(hi))
    return (torch.round(x) if rounding else x).to(torch.int32)


def visibility_cleanup_polar(
    layers: torch.Tensor,
    normal: torch.Tensor,
    assoc: PointAssociation,
    inlier_cnt: torch.Tensor,
    t: torch.Tensor,
    cfg: MapConfig,
) -> torch.Tensor:
    """Shadow-cube visibility cleanup (the JAX package's
    ``visibility_cleanup_polar``, raycast.py:1008-1237).

    Rays are binned once into an (azimuth A, radius R, elevation S) cube of
    {count, sum(1/ray_len)} (and, with ``raycast_slope_from_bins=False``, the
    min slope); a suffix scan along R turns it into "rays still active at
    radius >= r", an azimuth prefix sum (and ring min-pyramid) makes the
    azimuth axis range-queryable, and each map cell answers its penetration
    query with a few row gathers plus a reduction over the S elevation
    buckets. The two cube scatter-adds are one 2-stream launch of kernel K1.
    """
    n = cfg.cell_n
    A = cfg.azimuth_bins
    S = cfg.raycast_elevation_bins
    R = cfg.n_ray_steps + 2
    step = cfg.ray_step
    dt = layers.dtype
    dev = layers.device
    two_pi = 2.0 * math.pi

    p = assoc.world
    v = p - t
    len_xy = torch.sqrt(v[:, 0] ** 2 + v[:, 1] ** 2)
    len3d = torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1), min=1e-30))
    phi = torch.atan2(v[:, 2], len_xy)                    # elevation
    az = torch.atan2(v[:, 1], v[:, 0])                    # azimuth [-pi, pi]
    slope = v[:, 2] / torch.clamp(len_xy, min=1e-30)      # tan(phi)

    a_idx = _bin((az + math.pi) * (A / two_pi), A - 1)
    s_idx = _bin((phi + math.pi / 2) * (S / math.pi), S - 1)

    ray_len = torch.clamp(len3d, max=cfg.max_ray_length)
    s_max = torch.minimum(len3d - math.sqrt(0.1), ray_len)  # active span
    r_act = torch.cos(phi) * s_max                        # xy radius bound
    r_idx = _bin(true_div(r_act, step), R - 1, rounding=True)
    active = assoc.valid & (r_act > 0) & (len3d > 0)

    cube_idx = (a_idx * R + r_idx) * S + s_idx            # layout (A, R, S)
    inv_len = 1.0 / torch.clamp(ray_len, min=1e-30)

    cubes = scatter.scatter_add_multi(A * R * S, cube_idx, [torch.ones_like(inv_len), inv_len], active)
    cnt_cube = cubes[0].reshape(A, R, S)
    inv_cube = cubes[1].reshape(A, R, S)
    use_bins_slope = cfg.raycast_slope_from_bins
    if not use_bins_slope:
        slope_cube = scatter.scatter_min(A * R * S, cube_idx, slope, active, math.inf).reshape(A, R, S)

    # suffix scans along R: "rays with r_act >= r"
    cnt_suf = torch.flip(torch.cumsum(torch.flip(cnt_cube, [1]), dim=1), [1])
    inv_suf = torch.flip(torch.cumsum(torch.flip(inv_cube, [1]), dim=1), [1])

    # azimuth prefix for range sums; cnt+inv packed into one (A, R, 2S) tensor
    packed = torch.cat([cnt_suf, inv_suf], dim=-1)
    pref = torch.cumsum(packed, dim=0)                    # (A, R, 2S)
    total = pref[-1]                                      # (R, 2S)

    # ring min-pyramid over azimuth: level l = window [a, a + 2^l)
    n_levels = min(cfg.raycast_pyramid_levels, max(1, math.ceil(math.log2(A))))
    if not use_bins_slope:
        slope_suf = torch.flip(torch.cummin(torch.flip(slope_cube, [1]), dim=1).values, [1])
        levels = [slope_suf]
        for lv in range(1, n_levels + 1):
            prev = levels[-1]
            levels.append(torch.minimum(prev, torch.roll(prev, -(1 << (lv - 1)), dims=0)))
        pyramid = torch.stack(levels)                     # (L+1, A, R, S)

    # ---- per-cell evaluation ----
    i = torch.arange(n * n, dtype=torch.int32, device=dev)
    row_i = i // n
    col_i = i % n
    cx = (row_i.to(dt) + 0.5 - 0.5 * n) * cfg.resolution - t[0]
    cy = (col_i.to(dt) + 0.5 - 0.5 * n) * cfg.resolution - t[1]
    r_c = torch.sqrt(cx * cx + cy * cy)
    a_c = torch.atan2(cy, cx)
    ai = _bin((a_c + math.pi) * (A / two_pi), A - 1)
    ri = _bin(true_div(r_c, step), R - 1, rounding=True)
    in_range = (r_c <= cfg.max_ray_length) & (r_c >= step * 0.5)

    # azimuth half-window = the cell's crossing band for rays at this azimuth
    abs_c = torch.abs(torch.cos(a_c))
    abs_s = torch.abs(torch.sin(a_c))
    band = cfg.resolution * (abs_c + abs_s)
    half_ang = torch.atan2(0.5 * band, torch.clamp(r_c, min=1e-6))
    hw = _bin(half_ang * (A / two_pi), A // 2 - 1)
    lo = ai - hw
    hi = ai + hw
    width = 2 * hw + 1

    # single-row gathers at the joint (azimuth, radius) index
    ril = ri.long()
    pref_flat = pref.reshape(A * R, 2 * S)
    hi_rows = pref_flat[((hi % A) * R + ri).long()]
    lo_rows0 = pref_flat[(((lo - 1) % A) * R + ri).long()]
    zero_lo = (lo % A) == 0
    lo_rows = torch.where(zero_lo[:, None], 0.0, lo_rows0)
    tot_rows = total.reshape(R, 2 * S)[ril]
    wrapped = (lo % A) > (hi % A)
    sums_rows = torch.where(wrapped[:, None], tot_rows - (lo_rows - hi_rows), hi_rows - lo_rows)
    cnt_k = sums_rows[:, :S]
    inv_k = sums_rows[:, S:]

    if not use_bins_slope:
        # windowed min query: level l = ceil(log2(width)); two windows cover it
        lvl = torch.clamp(torch.ceil(torch.log2(width.to(dt))), 0, n_levels).to(torch.int32)
        start1 = lo % A
        start2 = (lo + width - (torch.ones_like(lvl) << lvl)) % A
        pyr_flat = pyramid.reshape((n_levels + 1) * A * R, S)
        m1 = pyr_flat[((lvl * A + start1) * R + ri).long()]
        m2 = pyr_flat[((lvl * A + start2) * R + ri).long()]
        slope_k_min = torch.minimum(m1, m2)               # (n*n, S)

    flatL = layers.reshape(7, -1)
    cell_h = flatL[0]
    cell_v = flatL[1]
    cell_valid = flatL[2]
    cell_t = flatL[4]
    cell_ub = flatL[5]
    cell_iub = flatL[6]
    nrm = normal.reshape(3, -1)
    ic = inlier_cnt.reshape(-1)

    inside = (row_i > 0) & (row_i < n - 1) & (col_i > 0) & (col_i < n - 1)

    # bucket-center angles in float32, as the JAX package computes them
    phi_k = (torch.arange(S, dtype=dt, device=dev) + 0.5) * (math.pi / S) - math.pi / 2
    tan_k = torch.tan(phi_k)
    cos_pk = torch.cos(phi_k)
    sin_pk = torch.sin(phi_k)

    safe_r = torch.clamp(r_c, min=1e-6)

    # the exact march evaluates each cell at its entry sample, not its
    # center: expected evaluation radius is r_c minus half the mean chord
    # (res^2 / band) plus half the xy sample spacing
    delta_k = cfg.ray_step * cos_pk                       # (S,) xy spacing
    mean_chord = cfg.resolution**2 / torch.clamp(band, min=1e-9)
    r_eval = torch.clamp(
        safe_r[:, None] - 0.5 * mean_chord[:, None] + 0.5 * delta_k[None, :], min=1e-6
    )                                                     # (n*n, S)

    s_star_num = cell_h - 0.01 + torch.clamp(cell_v, max=1.0) * 0.05 - t[2]
    pen_k = tan_k[None, :] * r_eval < s_star_num[:, None]

    g_c = torch.cos(a_c) * nrm[0] + torch.sin(a_c) * nrm[1]
    dot_k = torch.abs(g_c[:, None] * cos_pk[None, :] + nrm[2][:, None] * sin_pk[None, :])
    cos_ok = dot_k >= cfg.cleanup_cos_thresh

    # sampling-acceptance correction: P(hit | chord l) = min(1, l / delta)
    # integrated over the chord profile of a square cell
    mx = torch.maximum(abs_c, abs_s)
    w_lin = band[:, None] - delta_k[None, :] * (abs_c * abs_s)[:, None]
    w_sat = (cfg.resolution**2) / torch.clamp(delta_k[None, :], min=1e-9)
    use_sat = delta_k[None, :] >= (cfg.resolution / torch.clamp(mx, min=1e-9))[:, None]
    w_eff = torch.where(use_sat, w_sat, w_lin)
    accept_k = torch.clamp(w_eff / torch.clamp(band[:, None], min=1e-9), 0.0, 1.0)

    has_rays = cnt_k > 0.5
    is_invalid = cell_valid < 0.5
    not_recent = cell_t >= 0.5
    wall_skip = (ic > cfg.wall_num_thresh) & (cell_t < 1.0)
    cell_gate = in_range & inside & ~is_invalid & not_recent & ~wall_skip

    hit_k = has_rays & pen_k & cos_ok & cell_gate[:, None]
    dec = cfg.cleanup_step * cfg.max_ray_length * torch.sum(
        torch.where(hit_k, inv_k * accept_k, 0.0), dim=1
    )
    var = cfg.outlier_variance * torch.sum(torch.where(hit_k, cnt_k * accept_k, 0.0), dim=1)

    # upper-bound candidates: min ray height per bucket at the eval radius
    if use_bins_slope:
        nz_k = t[2] + r_eval * tan_k[None, :]
    else:
        nz_k = t[2] + r_eval * slope_k_min
    ub_cond_k = (cell_iub[:, None] < 0.5) | (nz_k < cell_ub[:, None])
    candA = (in_range & inside & is_invalid)[:, None] & has_rays & ub_cond_k
    candB = hit_k & ub_cond_k
    cand = candA | candB
    ubmin = torch.amin(torch.where(cand, nz_k, math.inf), dim=1)
    wrote = torch.isfinite(ubmin)

    out = flatL.clone()
    out[2] -= dec.to(dt)
    out[1] += var.to(dt)
    out[5] = torch.where(wrote, ubmin.to(dt), out[5])
    out[6] = torch.where(wrote, 1.0, out[6])
    return out.reshape(7, n, n)
