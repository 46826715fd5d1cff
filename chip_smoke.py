#!/usr/bin/env python3
"""Drive the PyTorch port (``elevation_mapping_cupy_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any fault:

1. device  - the card's name, count and power limit; no card, no run.
2. build   - every CUDA kernel of the port, built from ``csrc/`` with nvcc
             (one process per source, all started together).
3. kernels - each kernel against its plain PyTorch version on the card, at
             the main path's shapes, with its time, the plain version's, one
             PyTorch library call's, and the bound (bytes over 3.35 TB/s).
4. main    - ``ElevationMap(deployed config, device="cuda")`` with the
             shipped weights takes 20 updates of a seeded synthetic scene of
             131072 points while the robot moves (``move_to``); every update
             must launch K1 exactly 3 times. The last 3 updates are rerun
             from the same state on ``device="cpu"`` and compared layer by
             layer. Then per-update latency and points/s at 10k, 131072 and
             1M points, the peak device memory, and a torch.profiler view
             of where one update's device time goes.

The line before the last is the card's name and power limit as nvidia-smi
gives them, the one before it the kernels line, and the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
N_UPDATES = 20
MAIN_POINTS = 131072
RATE_POINTS = (10_000, 131072, 1_000_000)
# CUDA vs CPU on one update from the same state (the polar tolerance of
# tests/test_torch_ops.py, 1e-4 per layer, held on all but a small share of
# cells: atan2/tan/sin/cos round differently on the card and on the CPU by an
# ulp, which can move a ray into the neighbouring azimuth or elevation bin)
CMP_ATOL = 1e-4
CMP_MIN_SHARE = 0.999
# K1 value streams vs the plain version: B1's 2e-4 (tests/test_pallas_scatter.py),
# relative to the sum once a cell's sum exceeds 1. Both sides add float32 in
# an order the atomics pick, and the cells near the sensor sum thousands of
# points: one ulp of a sum of 2000 is 1.2e-4.
VALUE_TOL = 2e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def deployed_config():
    """``configs/core_param.yaml`` as a ``MapConfig`` literal: the card's
    machine has no PyYAML. tests/test_torch_core.py checks that this equals
    the port's ``load_config("configs/core_param.yaml")``."""
    from elevation_mapping_cupy_torch.config import MapConfig

    return MapConfig(
        resolution=0.04, map_length=8.0,
        sensor_noise_factor=0.05, mahalanobis_thresh=2.0, outlier_variance=0.01,
        drift_compensation_variance_inlier=0.05, time_variance=0.0001,
        max_variance=100.0, initial_variance=1000.0,
        dilation_size=3, wall_num_thresh=20,
        enable_drift_compensation=True, max_drift=0.1, drift_compensation_alpha=0.1,
        traversability_inlier=0.9, min_height_drift_cnt=100,
        position_noise_thresh=0.01, orientation_noise_thresh=0.01,
        enable_visibility_cleanup=True, max_ray_length=10.0, cleanup_step=0.1,
        cleanup_cos_thresh=0.1, raycast_mode="auto",
        min_valid_distance=0.5, max_height_range=1.0, ramped_height_range_a=0.3,
        ramped_height_range_b=1.0, ramped_height_range_c=0.2,
        time_interval=0.1,
        enable_edge_sharpen=True, enable_overlap_clearance=True,
        overlap_clear_range_xy=4.0, overlap_clear_range_z=2.0,
        safe_thresh=0.7, safe_min_thresh=0.4, max_unsafe_n=10,
        checker_layer="traversability",
        use_only_above_for_upper_bound=False,
        dilation_size_initialize=2,
        tolerance_z_collision=0.10, image_occlusion_mode="shadow",
        max_points=131072,
    )


# ---------------------------------------------------------------------------
# synthetic scene
# ---------------------------------------------------------------------------

BOXES = (  # (x0, y0, x1, y1, height) in metres, world frame
    (1.2, -0.6, 1.8, 0.2, 0.35),
    (-2.2, 0.8, -1.4, 1.6, 0.8),
    (0.4, 1.5, 1.0, 2.4, 0.15),
    (-0.8, -2.6, 0.6, -1.9, 0.55),
)


def robot_pose(k: int):
    """Sensor pose of update k: the robot drives a slow arc, the sensor 0.7 m
    above the ground, turning 2 degrees per update."""
    yaw = math.radians(2.0 * k)
    c, s = math.cos(yaw), math.sin(yaw)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    pos = np.array([0.03 * k, 0.012 * k, 0.0], np.float32)
    return R, pos + np.array([0.0, 0.0, 0.7], np.float32), pos


def scene_cloud(rng: np.random.Generator, n: int, R: np.ndarray, t: np.ndarray, r_max: float = 6.0):
    """n sensor-frame points of ground (z=0) and box tops and sides around
    the sensor, with 1 cm of noise; density falls with range like a lidar's."""
    n_wall = n // 5
    n_ground = n - n_wall
    r = 0.4 + (r_max - 0.4) * rng.random(n_ground) ** 1.5
    a = rng.uniform(-math.pi, math.pi, n_ground)
    x = t[0] + r * np.cos(a)
    y = t[1] + r * np.sin(a)
    z = np.zeros(n_ground)
    for x0, y0, x1, y1, h in BOXES:
        on = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
        z[on] = h
    box = rng.integers(0, len(BOXES), n_wall)
    b = np.asarray(BOXES)[box]
    u = rng.random(n_wall)
    side = rng.integers(0, 4, n_wall)
    wx = np.where(side < 2, b[:, 0] + u * (b[:, 2] - b[:, 0]), np.where(side == 2, b[:, 0], b[:, 2]))
    wy = np.where(side >= 2, b[:, 1] + u * (b[:, 3] - b[:, 1]), np.where(side == 0, b[:, 1], b[:, 3]))
    wz = rng.random(n_wall) * b[:, 4]
    world = np.stack([np.concatenate([x, wx]), np.concatenate([y, wy]), np.concatenate([z, wz])], 1)
    world += rng.normal(0.0, 0.01, world.shape)
    return ((world - t) @ R).astype(np.float32)  # R^T (p - t), row-wise


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} x{count}; nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    return name, count, smi


def phase_build():
    from elevation_mapping_cupy_torch import kernels

    regs = kernels.registered_kernels()
    t0 = time.perf_counter()
    libs = kernels.build_all(sorted({k.source for k in regs.values()}))
    for k in regs.values():
        k.load()
    log(f"build: {len(libs)} source(s) in {time.perf_counter() - t0:.2f} s: {', '.join(os.path.basename(p) for p in libs)}")
    return regs


def _events_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _cell_indices(rng, b: int, n: int, n_cells: int) -> np.ndarray:
    """Main-path-like indices: point density falling with range from the
    middle of a square grid (or the middle of a flat bin range)."""
    side = int(math.isqrt(n_cells))
    if side * side == n_cells:
        r = (side / 2 - 1) * rng.random((b, n)) ** 1.5
        a = rng.uniform(-math.pi, math.pi, (b, n))
        row = np.clip(side / 2 + r * np.cos(a), 0, side - 1).astype(np.int64)
        col = np.clip(side / 2 + r * np.sin(a), 0, side - 1).astype(np.int64)
        return (row * side + col).astype(np.int32)
    return np.clip(n_cells * rng.beta(2.0, 3.0, (b, n)), 0, n_cells - 1).astype(np.int32)


def check_scatter_case(rng, label: str, b: int, n: int, n_cells: int, exact, timed: bool = True):
    """K1 against its plain version on the card at one shape; returns the
    measured numbers."""
    from elevation_mapping_cupy_torch.ops import cuda_scatter as cs

    k = len(exact)
    dev = "cuda"
    idx = torch.from_numpy(_cell_indices(rng, b, n, n_cells)).to(dev)
    mask = torch.from_numpy(rng.random((b, n)) > 0.15).to(dev)
    vals_np = rng.normal(0.5, 0.3, (b, k, n)).astype(np.float32)
    for s, e in enumerate(exact):
        if e:
            vals_np[:, s] = rng.integers(0, 2, (b, n))
    vals = torch.from_numpy(vals_np).to(dev)

    got = cs.scatter_add_streams(idx, mask, vals, n_cells)
    want = cs.scatter_add_streams_reference(idx, mask, vals, n_cells)
    torch.cuda.synchronize()
    if got.shape != (b, k, n_cells) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: bad output shape {tuple(got.shape)} or non-finite values")
    err = rel = 0.0
    for s, e in enumerate(exact):
        diff = (got[:, s] - want[:, s]).abs()
        d = float(diff.max()) if got.numel() else 0.0
        r = float((diff / want[:, s].abs().clamp(min=1.0)).max()) if got.numel() else 0.0
        if e and not torch.equal(got[:, s], want[:, s]):
            raise AssertionError(f"{label}: exact stream {s} differs from the plain version (max {d})")
        if not e and r > VALUE_TOL:
            raise AssertionError(f"{label}: value stream {s} off by {r} (relative) > {VALUE_TOL}")
        err, rel = max(err, d), max(rel, r)
    res = {"case": label, "B": b, "N": n, "K": k, "n_cells": n_cells, "max_abs_err": err, "max_rel_err": rel}
    if not timed:
        log("kernel check: " + json.dumps(res))
        return res

    n_active = int(mask.sum())
    bytes_moved = b * n * (4 + 1) + n_active * 4 * k + b * k * n_cells * 4
    res["bound_ms"] = bytes_moved / HBM_BYTES_PER_S * 1e3
    iters = 10 if n_cells > 1 << 22 else 50
    res["kernel_ms"] = _events_ms(lambda: cs.scatter_add_streams(idx, mask, vals, n_cells), iters)
    res["plain_ms"] = _events_ms(lambda: cs.scatter_add_streams_reference(idx, mask, vals, n_cells), iters)
    # yardstick only (the port never calls it): one index_put_ with
    # accumulate=True on the flat output, indices expanded per stream
    keep = mask[:, None, :].expand(b, k, n)
    base = (torch.arange(b * k, device=dev) * n_cells).view(b, k, 1)
    flat_idx = (base + idx[:, None, :].long())[keep]
    flat_val = vals[keep]

    def library():
        out = torch.zeros(b * k * n_cells, device=dev)
        out.index_put_((flat_idx,), flat_val, accumulate=True)
        return out

    lib = library().view(b, k, n_cells)
    if not torch.allclose(lib, want, atol=VALUE_TOL, rtol=VALUE_TOL):
        raise AssertionError(f"{label}: the library yardstick disagrees with the plain version")
    res["library_ms"] = _events_ms(library, iters)
    log("kernel check: " + json.dumps(res))
    return res


def phase_kernels(cfg):
    """K1 at every shape the main path gives it, plus the edge cases."""
    rng = np.random.default_rng(0)
    cells = cfg.cell_n * cfg.cell_n
    bins = cfg.azimuth_bins * (cfg.n_ray_steps + 2) * cfg.raycast_elevation_bins
    cases = {}
    for n in (MAIN_POINTS, 1 << 20):
        cases[("count", n)] = check_scatter_case(rng, f"error counting N={n}", 1, n, cells, (True, True))
        cases[("fusion", n)] = check_scatter_case(
            rng, f"point fusion N={n}", 1, n, cells, (False, False, True, True)
        )
        cases[("cube", n)] = check_scatter_case(rng, f"polar cube N={n}", 1, n, bins, (True, False))
    check_scatter_case(rng, "zero points", 1, 0, cells, (True, True), timed=False)
    check_scatter_case(rng, "batched B=4", 4, MAIN_POINTS, cells, (False, False, True, True), timed=False)
    return cases


def _compare_layers(tag: str, got: dict, want: dict) -> dict:
    stats = {}
    for name in want:
        a, b = got[name], want[name]
        both_nan = np.isnan(a) & np.isnan(b)
        close = both_nan | (np.abs(np.nan_to_num(a, nan=1e9) - np.nan_to_num(b, nan=1e9)) <= CMP_ATOL)
        share = float(close.mean())
        finite = np.isfinite(a) & np.isfinite(b)
        stats[name] = {
            "share_within": share,
            "max_abs": float(np.abs(a[finite] - b[finite]).max()) if finite.any() else 0.0,
        }
        if not share >= CMP_MIN_SHARE:
            raise AssertionError(
                f"{tag}: layer {name}: {share:.5f} of cells within {CMP_ATOL} of the CPU run "
                f"(need {CMP_MIN_SHARE})"
            )
    return stats


def phase_main(cfg, kernel_regs):
    from elevation_mapping_cupy_torch.mapper import ElevationMap
    from elevation_mapping_cupy_torch.ops import raycast
    from elevation_mapping_cupy_torch.state import state_from_numpy, state_to_numpy

    if raycast.resolve_raycast_mode(cfg) != "polar":
        raise AssertionError("the deployed config must resolve to the polar cleanup")
    layers = ["elevation", "variance", "is_valid", "traversability", "time",
              "upper_bound", "is_upper_bound", "normal_x", "normal_y", "normal_z"]
    rng = np.random.default_rng(1)
    em = ElevationMap(cfg, device="cuda")
    cpu = ElevationMap(cfg, device="cpu")

    def update(k: int, n: int):
        R, t, pos = robot_pose(k)
        pts = scene_cloud(rng, n, R, t)
        em.move_to(pos, R)
        noise = 0.02 if k % 4 == 0 else 0.0  # every 4th update opens the drift gate
        return pts, R, t, noise

    # warm-up (CUDA context, cuDNN plans, allocator), not counted
    for k in range(2):
        pts, R, t, noise = update(k, MAIN_POINTS)
        em.input_pointcloud(pts, ["x", "y", "z"], R, t, noise, 0.0)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    for kern in kernel_regs.values():
        kern.launches = 0
    lat, cmp_stats = [], []
    for k in range(2, 2 + N_UPDATES):
        pts, R, t, noise = update(k, MAIN_POINTS)
        last = k >= 2 + N_UPDATES - 3
        if last:
            before = state_to_numpy(em.state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        em.input_pointcloud(pts, ["x", "y", "z"], R, t, noise, 0.0)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        if last:
            cpu.state = state_from_numpy(before, "cpu")
            cpu.input_pointcloud(pts, ["x", "y", "z"], R, t, noise, 0.0)
            cmp_stats.append(_compare_layers(f"update {k}", em.get_layers(layers), cpu.get_layers(layers)))
    launches = {name: kern.launches for name, kern in kernel_regs.items()}
    peak = torch.cuda.max_memory_allocated()
    if launches["scatter_add_streams"] != 3 * N_UPDATES:
        raise AssertionError(f"K1 launched {launches['scatter_add_streams']} times in {N_UPDATES} updates, want 3 each")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    out = em.get_layers(layers)
    if not all(v.shape == (cfg.cell_n - 2, cfg.cell_n - 2) for v in out.values()):
        raise AssertionError("exported layers have the wrong shape")
    valid = out["is_valid"] > 0.5
    if valid.mean() < 0.2 or not np.isfinite(out["elevation"][valid]).all():
        raise AssertionError(f"implausible map: {valid.mean():.3f} of cells valid")
    lat_ms = np.array(lat) * 1e3
    res = {
        "updates": N_UPDATES,
        "points": MAIN_POINTS,
        "latency_ms_median": float(np.median(lat_ms)),
        "latency_ms_p90": float(np.percentile(lat_ms, 90)),
        "launches": launches,
        "peak_memory_bytes": int(peak),
        "valid_share": float(valid.mean()),
        "cpu_compare": cmp_stats,
    }
    log("main path: " + json.dumps(res))

    rates = {}
    for n in RATE_POINTS:
        times = []
        for k in range(12):
            pts, R, t, noise = update(100 + k, n)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            em.input_pointcloud(pts, ["x", "y", "z"], R, t, noise, 0.0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = float(np.median(times[2:]))
        rates[n] = {"latency_ms_median": med * 1e3, "points_per_s": n / med}
    log("points/s: " + json.dumps(rates))
    prof = profile_updates(em, rng)
    # the profiler slows the host, so the busy share is taken against the
    # unprofiled latency of the main path
    prof["device_busy_share_of_median_latency"] = prof["device_ms_per_update"] / res["latency_ms_median"]
    log("profile: " + json.dumps(prof))
    return res, launches


def profile_updates(em, rng, n_updates: int = 5) -> dict:
    """Where one update's time goes: torch.profiler over back-to-back
    updates of MAIN_POINTS points (clouds made beforehand, no map motion):
    device time and device operations per update, the host clock under the
    profiler, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    R, t, _ = robot_pose(300)
    clouds = [scene_cloud(rng, MAIN_POINTS, R, t) for _ in range(n_updates)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for pts in clouds:
            em.input_pointcloud(pts, ["x", "y", "z"], R, t, 0.0, 0.0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:12]
    return {
        "updates": n_updates,
        "wall_ms_per_update": wall_us / n_updates / 1e3,
        "device_ms_per_update": dev_us / n_updates / 1e3,
        "device_busy_share_profiled": dev_us / wall_us,
        "device_ops_per_update": sum(e.count for e in dev) / n_updates,
        "top_device_ms_per_update": {
            e.key[:80]: round(e.self_device_time_total / n_updates / 1e3, 4) for e in top
        },
    }


def kernels_line(cases, launches, n_main: int) -> dict:
    """One entry per kernel. K1's numbers are those of one update's three
    launches at the main path's cloud size (error counting, fusion, cube)."""
    shapes = [cases[(c, n_main)] for c in ("count", "fusion", "cube")]
    total = lambda key: sum(s[key] for s in shapes)  # noqa: E731
    return {
        "kernels": [
            {
                "name": "scatter_add_streams",
                "route": "cuda",
                "source": "elevation_mapping_cupy_torch/csrc/scatter_add.cu",
                "replaces": "elevation_mapping_cupy_tpu/ops/pallas_scatter.py:142",
                "function": "_kernel",
                "checked": True,
                "launches": launches["scatter_add_streams"],
                "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
                "ms": total("kernel_ms"),
                "plain_ms": total("plain_ms"),
                "bound_ms": total("bound_ms"),
                "bound_by": "bytes",
                "library_ms": total("library_ms"),
            }
        ]
    }


def main() -> int:
    name, count, smi = phase_device()
    regs = phase_build()
    cfg = deployed_config()
    cases = phase_kernels(cfg)
    _, launches = phase_main(cfg, regs)
    print(json.dumps(kernels_line(cases, launches, MAIN_POINTS)))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
