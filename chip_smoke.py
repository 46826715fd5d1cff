#!/usr/bin/env python3
"""Time the PyTorch port's hand-written CUDA kernels on one card.

    python3 chip_smoke.py [--json PATH]

Each kernel is checked against its plain PyTorch version on the card and
timed at the shapes the benchmark's cells give it; the numbers are the
kernel table of PERF.md. Then the two deployed paths run once at their
widths, each against the CPU port, and give the kernels' launches on them.
Every other path through the kernels is held by ``tests/test_torch_cuda.py``.
Phases, each of which fails the run (non-zero exit) on any fault:

1. device  - the card's name, count and power limit; no card, no run.
2. build   - every CUDA kernel of the port, built from ``csrc/`` with nvcc
             (one process per source, all started together).
3. kernels - K1 (``scatter_add_streams``) at the robot's shapes (the
             deployed map, 131072 and 1048576 points: error counting and
             point fusion on the shared-memory path, the polar cube on the
             global path) and datagen's (the default map, B = 64 and 8 maps
             of 100000 points a launch), integer streams bit for bit and
             value streams within 2e-4 relative to max(1, |sum|); then zero
             points, B = 4, and both sides of the shared-memory limit,
             untimed. D1 (``dilation_fill``) bit for bit on a mapped disc of
             heights (with NaN) and masks read from a (B, 7, n, n) stack as
             the update reads them: the robot's update (B = 1, size 3),
             datagen's step (B = 8 and 64, size 2) and the default
             initialize_map (size 10). D2 (``polar_evaluate``) on the
             arguments an update hands it once the map has aged past the
             recency gate: the robot's update (R 355, with and without the
             min-slope pyramid) and datagen's step (B = 8 and 64, R 72);
             channels 0 and 3-6 bit for bit, 1 and 2 within 1e-5 of
             max(1, |plain|). D3 (``polar_scan``) bit for bit on the
             cube K1 bins in the same updates (robot, B = 8 and 64). D4
             (``points_associate``) and D5 (``points_fuse``) bit for bit
             (D4's error sums within 1e-6) on a made-up cloud and map at
             the robot's shape (B = 1 of 131072 points on the deployed map)
             and datagen's (B = 64 maps of 100000 points on the default
             map). K2 (``exact_march``) on the robot's map of 22
             updates, aged, for 131072 and 1048576 rays, gate on and off
             (the same on the map before it is aged: the gated march against
             the flat one on a fresh map); then one launch for datagen_exact's
             B = 64 maps of 100000 rays (70 steps, gated), on fresh maps and
             on maps of 8 steps aged past the recency gate; hit counts,
             upper bounds and segment counts equal, the decrement within
             2e-4.
             Each timed case gives the call's time (CUDA events around the
             wrapper), the device's own (torch.profiler), the plain
             version's, one PyTorch library call's where one computes the
             same, and the bound (bytes over 3.35 TB/s; K2: the larger of
             that and its float32 operations over 67 TFLOP/s).
4. paths   - with every kernel's launch count at 0 before each: one
             MappingService frame of 131072 raw points on the deployed map
             (after one warm-up frame), and one batched_update step of
             datagen's B = 64 and of B = 8 maps of 100000 points on the
             default map (after one warm-up step). The same inputs through
             the CPU port: every layer within 1e-4 on 99.9 % of cells. Each
             path must launch K1 three times, D1 to D5 once and K2 never.
             Then one step of 64 maps with the exact cleanup, on maps of 7
             steps aged past the recency gate, against the CPU port: K1
             twice, K2, D1, D4 and D5 once, D2 and D3 never.

The line before the last is the card's name and power limit as nvidia-smi
gives them, the one before it the kernels line, and the last line is
``{"ok": true, "device": {...}}``. ``--json PATH`` also writes every
measured number of the run to PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from tests import torch_scenes as scenes

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 rate outside the tensor cores (data sheet)
MAIN_POINTS = scenes.MAIN_POINTS
BATCH_POINTS = 100_000      # datagen's points a map (benchmark/traffic/b64_ep8.json, b8_ep8.json)
BATCH_SIZES = (64, 8)
MARCH_RAYS = (131072, 1 << 20)
MARCH_UPDATES = 22          # polar updates of the map K2 marches on
# float32 operations that the march's function needs, an FMA counted as two
# (csrc/exact_march.cu), for each item of the plain version's work tally on
# this run's inputs: per valid ray its table (difference 3, norm 5, root 1,
# direction 3, length 1, decrement 2, trim end 2, two step counts 2 each);
# per walked sample its distance along the ray 1, x and y 4, their cells 4;
# per fresh sample in the map its height 2, the offsets to the end point 3,
# their squared length 5 and its test 1; per tested sample the upper-bound
# compare; per one on an eligible cell the penetration test 3; per
# penetrating one the cosine 5, its magnitude and test 2; per hit the two
# sums; per upper-bound write its min; per segment the gate test (the two
# ends' distances 2, the first sample's x and y 4 and cells 4, the heights at
# both ends 4, their min 1, the slack and compare 2). Not counted: the
# kernel's recomputation of the previous step's cell and its clamps.
MARCH_OPS = {
    "rays": 21, "walked": 9, "fresh": 11, "tested": 1, "eligible": 3, "penetrating": 7,
    "hits": 2, "ub_writes": 1, "segments": 17,
}


def log(msg: str) -> None:
    print(msg, flush=True)


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


def _device_ms(fn, iters: int):
    """Device time of one call of ``fn``: everything it puts on the card
    (its kernel and whatever fill that needs), summed by name from
    torch.profiler over ``iters`` calls. Returns (ms per call, ms per call by
    device operation). ``_events_ms`` around the same call reads the larger
    of this and the host's time to enqueue it.

    The tracer now and then drops records at the edge of a window (often
    the window's first kernel), so an operation's time per call is its mean
    over the records that came through times the number of times a call
    runs it, not its total over ``iters``.

    Now and then the tracer returns no device record at all for a window:
    later windows also trace the host, and after five empty windows the
    time comes from CUDA events around the same calls, named so in the
    returned operations."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        acts = [ProfilerActivity.CUDA] if attempt < 2 else [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0]
        if dev:
            by_name = {
                e.key[:60]: e.self_device_time_total / e.count * max(1, round(e.count / iters)) / 1e3 for e in dev
            }
            return sum(by_name.values()), by_name
    ms = _events_ms(fn, iters)
    log(f"device time: the profiler saw no device operation in five windows; CUDA events read {ms} ms a call")
    return ms, {"cuda_events (no profiler record)": ms}


def scatter_case(rng, label: str, b: int, n: int, n_cells: int, exact, timed: bool = True, int_max: int = 1):
    """K1 against its plain version on the card at one shape
    (``scenes.check_scatter_case``), then its time beside the plain
    version's, one ``index_put_`` and the bound."""
    from elevation_mapping_cupy_torch.ops import cuda_scatter as cs

    res, (idx, mask, vals) = scenes.check_scatter_case(rng, label, b, n, n_cells, exact, int_max)
    if not timed:
        log("kernel check: " + json.dumps(res))
        return res
    k = len(exact)
    n_active = int(mask.sum())
    bytes_moved = b * n * (4 + 1) + n_active * 4 * k + b * k * n_cells * 4
    res["bound_ms"] = bytes_moved / HBM_BYTES_PER_S * 1e3
    iters = 10 if b * n_cells > 1 << 22 else 50
    res["kernel_ms"] = _events_ms(lambda: cs.scatter_add_streams(idx, mask, vals, n_cells), iters)
    res["device_ms"], res["device_ops_ms"] = _device_ms(lambda: cs.scatter_add_streams(idx, mask, vals, n_cells), iters)
    res["share_of_bound"] = res["bound_ms"] / res["device_ms"]
    res["plain_ms"] = _events_ms(lambda: cs.scatter_add_streams_reference(idx, mask, vals, n_cells), iters)
    # yardstick only (the port never calls it): one index_put_ with
    # accumulate=True on the flat output, indices expanded per stream
    keep = mask[:, None, :].expand(b, k, n)
    base = (torch.arange(b * k, device="cuda") * n_cells).view(b, k, 1)
    flat_idx = (base + idx[:, None, :].long())[keep]
    flat_val = vals[keep]

    def library():
        out = torch.zeros(b * k * n_cells, device="cuda")
        out.index_put_((flat_idx,), flat_val, accumulate=True)
        return out

    want = cs.scatter_add_streams_reference(idx, mask, vals, n_cells)
    if not torch.allclose(library().view(b, k, n_cells), want, atol=scenes.VALUE_TOL, rtol=scenes.VALUE_TOL):
        raise AssertionError(f"{label}: the library yardstick disagrees with the plain version")
    res["library_ms"] = _events_ms(library, iters)
    log("kernel check: " + json.dumps(res))
    return res


def phase_scatter(cfg) -> list:
    """K1 at the robot's and datagen's shapes, and the edge cases. The
    deployed map's scatters must take the shared-memory path and the cubes
    the global one."""
    from elevation_mapping_cupy_torch import MapConfig

    rng = np.random.default_rng(0)
    cases = []

    def geometry(tag, gcfg, b, n):
        cells = gcfg.cell_n ** 2
        bins = gcfg.azimuth_bins * (gcfg.n_ray_steps + 2) * gcfg.raycast_elevation_bins
        for kind, exact, n_cells in (("error counting", (True, True), cells),
                                     ("point fusion", (False, False, True, True), cells),
                                     ("polar cube", (True, False), bins)):
            res = scatter_case(rng, f"{tag} {kind} B={b} N={n}", b, n, n_cells, exact)
            if res["path"] != ("global" if kind == "polar cube" else "private"):
                raise AssertionError(f"K1 {res['case']} took the {res['path']} path")
            cases.append(res)

    for n in (MAIN_POINTS, 1 << 20):
        geometry("robot", cfg, 1, n)
    default = MapConfig()
    for b in BATCH_SIZES:
        geometry("datagen", default, b, BATCH_POINTS)
    cells = cfg.cell_n ** 2
    scatter_case(rng, "zero points", 1, 0, cells, (True, True), timed=False)
    scatter_case(rng, "batched B=4", 4, MAIN_POINTS, cells, (False, False, True, True), timed=False)
    # the largest map of the shared-memory path and the first past it
    scatter_case(rng, "58112 cells", 1, MAIN_POINTS, 58112, (False, True), timed=False)
    scatter_case(rng, "58113 cells", 1, MAIN_POINTS, 58113, (False, True), timed=False)
    return cases


def dilation_inputs(rng, b: int, n: int):
    """(heights, mask) as ``core.update_batch_aux`` hands them to the
    dilation: channel 5 of a (b, 7, n, n) stack (one stride between maps)
    and the sum of channels 2 and 6; valid cells on a disc with holes,
    some with NaN heights, and a few cells outside it."""
    yy, xx = np.mgrid[0:n, 0:n]
    disc = np.hypot(yy - n / 2, xx - n / 2) < 0.4 * n
    layers = np.zeros((b, 7, n, n), np.float32)
    layers[:, 5] = rng.normal(0.0, 0.3, (b, n, n))
    layers[:, 5][rng.random((b, n, n)) < 0.02] = np.nan
    layers[:, 2] = disc & (rng.random((b, n, n)) < 0.85)
    layers[:, 6] = (layers[:, 2] < 0.5) & (rng.random((b, n, n)) < 0.05)
    layers = torch.from_numpy(layers).to("cuda")
    return layers[:, 5], layers[:, 2] + layers[:, 6]


def check_dilation_case(rng, label: str, b: int, n: int, size: int) -> dict:
    """The dilation kernel against its plain version on the card at one
    shape: both outputs bit for bit, one launch a call; then its time."""
    from elevation_mapping_cupy_torch.ops import stencil as st

    height, mask = dilation_inputs(rng, b, n)
    before = st.KERNEL.launches
    got = st.dilation_fill(height, mask, size)
    torch.cuda.synchronize()
    if st.KERNEL.launches != before + 1:
        raise AssertionError(f"dilation {label}: {st.KERNEL.launches - before} launches in one call")
    want = st.dilation_fill_reference(height, mask, size)
    for part, g, w in zip(("heights", "mask"), got, want):
        if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
            raise AssertionError(f"dilation {label}: {part} differ from the plain version")
    filled = int(((mask < 0.5) & (got[1] == 1.0)).sum())
    res = {"case": label, "B": b, "n": n, "size": size, "filled_cells": filled,
           "bound_ms": 16 * b * n * n / HBM_BYTES_PER_S * 1e3}
    iters = 50
    res["kernel_ms"] = _events_ms(lambda: st.dilation_fill(height, mask, size), iters)
    res["device_ms"], res["device_ops_ms"] = _device_ms(lambda: st.dilation_fill(height, mask, size), iters)
    res["share_of_bound"] = res["bound_ms"] / res["device_ms"]
    res["plain_ms"] = _events_ms(lambda: st.dilation_fill_reference(height, mask, size), 3 if size >= 10 else 10)
    res["library_ms"] = None  # no PyTorch call computes the dilation
    log("dilation check: " + json.dumps(res))
    return res


def phase_dilation(cfg) -> list:
    """The dilation kernel at the shapes its callers give it."""
    from elevation_mapping_cupy_torch import MapConfig

    rng = np.random.default_rng(15)
    default = MapConfig()
    return [
        check_dilation_case(rng, "robot update", 1, cfg.cell_n, cfg.dilation_size),
        check_dilation_case(rng, "datagen step B=8", 8, default.cell_n, default.dilation_size),
        check_dilation_case(rng, "datagen step B=64", 64, default.cell_n, default.dilation_size),
        check_dilation_case(rng, "initialize_map", 1, default.cell_n, default.dilation_size_initialize),
    ]


def polar_inputs(cfg, b: int, n_points: int) -> tuple:
    """The polar cleanup's kernel arguments as an update hands them over, on
    maps aged past the recency gate after two updates, so that cells can be
    hit, lose validity and take upper bounds: b = 1 is the robot's map of
    the smoke scene (poses 0 to 2, then 3), b > 1 datagen's batch of
    ``make_batch_clouds`` terrains. Returns (the cube the scans take, the
    evaluation's arguments), both of the last update."""
    from elevation_mapping_cupy_torch import core
    from elevation_mapping_cupy_torch.mapper import ElevationMap
    from elevation_mapping_cupy_torch.nn.traversability import default_weights
    from elevation_mapping_cupy_torch.ops import raycast
    from elevation_mapping_cupy_torch.parallel import batched_update, init_batch
    from elevation_mapping_cupy_torch.runtime import datagen

    cubes, calls = [], []
    real_scan, real_evaluate = raycast.polar_scan, raycast.polar_evaluate

    def scan_spy(c):
        cubes.append(c.clone())
        return real_scan(c)

    def evaluate_spy(*args):
        calls.append(args)
        return real_evaluate(*args)

    def spied(fn):
        raycast.polar_scan, raycast.polar_evaluate = scan_spy, evaluate_spy
        try:
            return fn()
        finally:
            raycast.polar_scan, raycast.polar_evaluate = real_scan, real_evaluate

    if b == 1:
        em = ElevationMap(cfg, device="cuda")
        rng = np.random.default_rng(21)
        for k in range(4):
            if k == 3:
                for _ in range(7):
                    em.state = core.update_time(em.state, cfg)
            R, t, pos = scenes.robot_pose(k)
            em.move_to(pos, R)
            pts = scenes.scene_cloud(rng, n_points, R, t)
            update = lambda: em.input_pointcloud(pts, ["x", "y", "z"], R, t, 0.0, 0.0)  # noqa: E731
            spied(update) if k == 3 else update()
    else:
        cfg = cfg.replace(max_points=n_points)
        mask = torch.ones((b, n_points), dtype=torch.bool, device="cuda")
        R = torch.eye(3, device="cuda").expand(b, 3, 3).contiguous()
        z = torch.zeros(b, device="cuda")
        states = init_batch(cfg, b, "cuda")
        weights = default_weights().to("cuda")
        for k in range(3):
            if k == 2:
                for _ in range(7):
                    states = core.update_time(states, cfg)
            pts, t, _ = datagen.make_batch_clouds(datagen.make_generator(k, "cuda"), b, cfg.cell_n, cfg.resolution,
                                                  n_points)
            step = lambda: batched_update(states, pts, mask, R, t, z, z, weights, cfg)  # noqa: E731
            states = spied(step) if k == 2 else step()
    if len(cubes) != 1 or len(calls) != 1:
        raise AssertionError(f"polar inputs: {len(cubes)} scans and {len(calls)} evaluations in one update")
    return cubes[0], calls[0]


def check_scan_case(label: str, cubes) -> dict:
    """The polar cube's scan kernel against its plain version on the card,
    bit for bit, one launch a call; then its time beside the plain
    version's and its bound (two passes, each reading and writing B A R 2S
    floats)."""
    from elevation_mapping_cupy_torch.ops import raycast

    b, _, A, R, S = cubes.shape
    before = raycast.SCAN_KERNEL.launches
    got = raycast.polar_scan(cubes)
    torch.cuda.synchronize()
    if raycast.SCAN_KERNEL.launches != before + 1:
        raise AssertionError(f"polar scan {label}: {raycast.SCAN_KERNEL.launches - before} launches in one call")
    if not torch.equal(got.view(torch.int32), raycast._polar_scan(cubes).view(torch.int32)):
        raise AssertionError(f"polar scan {label}: differs from the plain version")
    res = {"case": label, "B": b, "A": A, "R": R, "S": S, "rays": float(cubes[:, 0].sum()),
           "bound_ms": 4 * b * A * R * 2 * S * 4 / HBM_BYTES_PER_S * 1e3}
    iters = 10 if b > 8 else 20
    res["kernel_ms"] = _events_ms(lambda: raycast.polar_scan(cubes), iters)
    res["device_ms"], res["device_ops_ms"] = _device_ms(lambda: raycast.polar_scan(cubes), iters)
    res["device_ms_per_map"] = res["device_ms"] / b
    res["share_of_bound"] = res["bound_ms"] / res["device_ms"]
    res["plain_ms"] = _events_ms(lambda: raycast._polar_scan(cubes), iters)
    res["plain_ms_per_map"] = res["plain_ms"] / b
    res["library_ms"] = None  # no one PyTorch call computes both scans
    log("polar scan check: " + json.dumps(res))
    return res


def check_polar_case(label: str, args) -> dict:
    """The polar evaluation kernel against its plain version on the card:
    channels 5 and 6 and the copied ones bit for bit, 1 and 2 within 1e-5
    of max(1, |plain|), one launch a call; then its time beside the plain
    version's and its bound (each map's prefix cube and pyramid read once,
    72 bytes a cell)."""
    from elevation_mapping_cupy_torch.ops import raycast

    layers, pyramid, (A, R, S, levels, block) = args[0], args[6], args[7]
    b = layers.shape[0]
    before = raycast.KERNEL.launches
    got = raycast.polar_evaluate(*args)
    torch.cuda.synchronize()
    if raycast.KERNEL.launches != before + 1:
        raise AssertionError(f"polar evaluation {label}: {raycast.KERNEL.launches - before} launches in one call")
    want = raycast._polar_evaluate_in_chunks(*args)
    for c in (0, 3, 4, 5, 6):
        if not torch.equal(got[:, c].contiguous().view(torch.int32), want[:, c].contiguous().view(torch.int32)):
            raise AssertionError(f"polar evaluation {label}: channel {c} differs from the plain version")
    rel = max(float(((got[:, c].double() - want[:, c].double()).abs()
                     / want[:, c].double().abs().clamp(min=1.0)).max()) for c in (1, 2))
    if not rel <= 1e-5:
        raise AssertionError(f"polar evaluation {label}: channels 1 and 2 {rel} off the plain version")
    cube = A * R * 2 * S + (0 if pyramid is None else (levels + 1) * A * R * S)
    res = {"case": label, "B": b, "A": A, "R": R, "S": S, "pyramid": pyramid is not None,
           "cells_changed": int((got[:, 2] != layers[:, 2]).sum()), "max_rel_err": rel,
           "bound_ms": b * (4 * cube + 72 * block.h * block.w) / HBM_BYTES_PER_S * 1e3}
    iters = 20
    res["kernel_ms"] = _events_ms(lambda: raycast.polar_evaluate(*args), iters)
    res["device_ms"], res["device_ops_ms"] = _device_ms(lambda: raycast.polar_evaluate(*args), iters)
    res["device_ms_per_map"] = res["device_ms"] / b
    res["share_of_bound"] = res["bound_ms"] / res["device_ms"]
    res["plain_ms"] = _events_ms(lambda: raycast._polar_evaluate_in_chunks(*args), 3, warmup=1)
    res["plain_ms_per_map"] = res["plain_ms"] / b
    res["library_ms"] = None  # no PyTorch call computes the evaluation
    log("polar evaluation check: " + json.dumps(res))
    return res


def phase_polar(cfg) -> tuple:
    """The polar cube's scan kernel and the polar evaluation kernel at the
    robot's shapes (B = 1, R 355) and datagen's (B = 8 and 64, R 72), each
    as an update hands them over; the evaluation also with the min-slope
    pyramid. Returns (scan cases, evaluation cases)."""
    from elevation_mapping_cupy_torch import MapConfig

    default = MapConfig()
    scans, evaluations = [], []
    for label, args in (("robot update", (cfg, 1, MAIN_POINTS)),
                        ("datagen step B=8", (default, 8, BATCH_POINTS)),
                        ("datagen step B=64", (default, 64, BATCH_POINTS))):
        cubes, evaluation = polar_inputs(*args)
        scans.append(check_scan_case(label, cubes))
        del cubes
        evaluations.append(check_polar_case(label, evaluation))
    evaluations.append(check_polar_case(
        "robot update, pyramid", polar_inputs(cfg.replace(raycast_slope_from_bins=False), 1, MAIN_POINTS)[1]))
    return scans, evaluations


def point_stage_bytes(b: int, n: int, masked: int, edge_sharpen: bool) -> tuple:
    """D4's and D5's compulsory bytes: each point's input read once (D4: its
    xyz and pad flag; D5: z, noise, index, mask and the cell's height and
    variance), the cells' values gathered (D4: four layers a point; D5: the
    point count a point under the mask, with edge sharpening) and the
    outputs written once (D4: world, noise, index, three flags, two streams,
    height and variance, 39 bytes; D5: four streams and the active flag)."""
    d4 = b * n * (12 + 1 + 16 + 39)
    d5 = b * n * (4 + 4 + 4 + 1 + 8 + 17) + (4 * masked if edge_sharpen else 0)
    return d4, d5


def check_point_stage_case(label: str, cfg, b: int, n: int) -> list:
    """D4 and D5 against their plain versions on the card at one shape
    (``scenes.check_point_stages``), then each kernel's time beside its
    plain version's and its bound. Returns one case a kernel."""
    from elevation_mapping_cupy_torch.ops import point_stages as ps
    from elevation_mapping_cupy_torch.ops import pointcloud as pc
    from elevation_mapping_cupy_torch.ops import scatter

    inputs = scenes.point_stage_inputs(cfg, b, n, "cuda", seed=23)
    res = scenes.check_point_stages(label, cfg, inputs)
    stage = ps.associate(*inputs, cfg)
    h, w = inputs[4].shape[-2:]
    sums = scatter.scatter_add_streams_2d(h, w, stage.assoc.flat_idx, stage.counted, stage.assoc.mask)
    counts = pc.ErrorCounts(sums[:, 0], sums[:, 1], stage.error_sum, stage.error_cnt)
    h_delta = torch.full((b,), 0.01, device="cuda")
    bounds = point_stage_bytes(b, n, res["masked"], cfg.enable_edge_sharpen)
    calls = (("points_associate", lambda: ps.associate(*inputs, cfg), lambda: ps._associate(*inputs, cfg)),
             ("points_fuse", lambda: ps.fuse(stage, h_delta, counts.point_cnt, cfg),
              lambda: ps._fuse(stage, h_delta, counts.point_cnt, cfg)))
    cases = []
    iters = 10 if b > 8 else 50
    for (name, kernel, plain), bytes_moved in zip(calls, bounds):
        case = dict(res, case=f"{label} {name}", kernel=name, bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3)
        case["kernel_ms"] = _events_ms(kernel, iters)
        case["device_ms"], case["device_ops_ms"] = _device_ms(kernel, iters)
        case["share_of_bound"] = case["bound_ms"] / case["device_ms"]
        case["plain_ms"] = _events_ms(plain, iters)
        case["library_ms"] = None  # no PyTorch call computes either stage
        log("point stage check: " + json.dumps(case))
        cases.append(case)
    return cases


def phase_point_stages(cfg) -> list:
    """D4 and D5 at the robot's shape (the deployed map, B = 1 of
    MAIN_POINTS) and datagen's (the default map, B = 64 of BATCH_POINTS)."""
    from elevation_mapping_cupy_torch import MapConfig

    return (check_point_stage_case("robot update", cfg, 1, MAIN_POINTS)
            + check_point_stage_case("datagen step B=64", MapConfig(), 64, BATCH_POINTS))


def check_march_case(state, cfg, rng, n_rays: int, gated: bool, aged: bool = True) -> dict:
    """K2 against its plain version on the card at one shape; returns the
    measured numbers. On a map that is not ``aged`` past the recency gate no
    cell can be hit, and the march only lowers upper bounds."""
    label = f"exact march N={n_rays} {'gated' if gated else 'ungated'}{'' if aged else ' fresh map'}"
    args = scenes.march_inputs(state, cfg, n_rays, rng, gated, pose=MARCH_UPDATES - 1)
    return march_case(label, cfg, args, gated, aged)


def march_bytes(b: int, n: int, n2: int, gate_cells: int) -> int:
    """K2's compulsory bytes for ``b`` maps of ``n`` rays and ``n2`` cells:
    per map the pack's 7 values per cell, the points, their validity, t,
    the gate table (``gate_cells`` floats, 0 without a gate), the three
    outputs and, with a gate, the two segment counts."""
    return b * (4 * (7 * n2 + 3 * n + 3 + gate_cells + 3 * n2) + n + (16 if gate_cells else 0))


def march_case(label: str, cfg, args, gated: bool, aged: bool, writes_ub: bool = True) -> dict:
    """K2 on ``args`` (pack, world, valid, t, gate; one map or a batch)
    against its plain version: hit counts, upper bounds and segment counts
    equal, the decrement within VALUE_TOL; then its time beside the plain
    version's and the bound. An ``aged`` case must hit cells, one that
    ``writes_ub`` must write upper bounds."""
    from elevation_mapping_cupy_torch.ops import cuda_march as cm

    got = cm.exact_march(*args[:4], cfg, args[4])
    work = {}
    want = cm.exact_march_reference(*args[:4], cfg, args[4], work=work)
    torch.cuda.synchronize()
    if not torch.equal(got.hits, want.hits):
        raise AssertionError(f"{label}: hit counts differ in {int((got.hits != want.hits).sum())} cells")
    if not torch.equal(got.ubmin, want.ubmin):
        raise AssertionError(f"{label}: upper bounds differ in {int((got.ubmin != want.ubmin).sum())} cells")
    if gated and not torch.equal(got.counts, want.counts):
        raise AssertionError(f"{label}: segment counts {got.counts.tolist()} vs {want.counts.tolist()}")
    diff = (got.dec - want.dec).abs()
    rel = float((diff / want.dec.abs().clamp(min=1.0)).max())
    if not bool(torch.isfinite(got.dec).all()) or rel > scenes.VALUE_TOL:
        raise AssertionError(f"{label}: decrement off by {rel} (relative) > {scenes.VALUE_TOL}")
    b = args[0].shape[0] if args[0].dim() == 3 else 1
    n2, n = cfg.cell_n**2, args[1].shape[-2]
    bytes_moved = march_bytes(b, n, n2, args[4].table.numel() // b if gated else 0)
    ops = sum(MARCH_OPS[key] * c for key, c in work.items())
    bytes_ms, ops_ms = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    counts = got.counts.reshape(-1, 2).sum(0).tolist() if gated else None
    res = {
        "case": label, "maps": b, "rays": n, "gated": gated, "aged": aged, "work": work,
        "counts": counts,
        "hit_cells": int((got.hits > 0).sum()), "hits": int(got.hits.sum()),
        "ub_cells": int(torch.isfinite(got.ubmin).sum()),
        "max_abs_err": float(diff.max()), "max_rel_err": rel,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "kernel_ms": _events_ms(lambda: cm.exact_march(*args[:4], cfg, args[4]), 20),
        # the comparison above was the plain version's warm-up
        "plain_ms": _events_ms(lambda: cm.exact_march_reference(*args[:4], cfg, args[4]), 1, warmup=0),
        # no single PyTorch call computes a ray march, so there is no yardstick
        "library_ms": None,
    }
    res["device_ms"], res["device_ops_ms"] = _device_ms(lambda: cm.exact_march(*args[:4], cfg, args[4]), 20)
    res["device_ms_per_map"] = res["device_ms"] / b
    res["share_of_bound"] = res["bound_ms"] / res["device_ms"]
    if (aged and res["hits"] == 0) or (writes_ub and res["ub_cells"] == 0):
        raise AssertionError(f"{label}: the case must hit cells or write upper bounds as it says: {res}")
    log("kernel check: " + json.dumps(res))
    return res


def phase_march(cfg) -> tuple:
    """K2 at the deployed shapes on the robot's map of MARCH_UPDATES polar
    updates of MAIN_POINTS points (every 4th with pose noise, which opens
    the drift gate), aged past the recency gate (time >= 0.5) so that cells
    can be hit, and on the same map before it is aged; the rays are the
    scene seen from the last update's pose."""
    from elevation_mapping_cupy_torch import core
    from elevation_mapping_cupy_torch.mapper import ElevationMap

    em = ElevationMap(cfg, device="cuda")
    rng = np.random.default_rng(1)
    for k in range(MARCH_UPDATES):
        R, t, pos = scenes.robot_pose(k)
        pts = scenes.scene_cloud(rng, MAIN_POINTS, R, t)
        em.move_to(pos, R)
        em.input_pointcloud(pts, ["x", "y", "z"], R, t, 0.02 if k % 4 == 0 else 0.0, 0.0)
    rng = np.random.default_rng(4)
    ecfg = cfg.replace(raycast_mode="exact")
    aged = em.state
    for _ in range(7):
        aged = core.update_time(aged, ecfg)
    cases = {(n, g): check_march_case(aged, ecfg, rng, n, g) for n in MARCH_RAYS for g in (True, False)}
    fresh = {(n, g): check_march_case(em.state, ecfg, rng, n, g, aged=False) for n in MARCH_RAYS for g in (True, False)}
    for name, group in (("aged", cases), ("fresh", fresh)):
        log(f"gated against flat, {name} map: " + json.dumps({
            str(n): {"gated_device_ms": group[(n, True)]["device_ms"], "flat_device_ms": group[(n, False)]["device_ms"],
                     "survivor_frac": group[(n, True)]["counts"][0] / max(group[(n, True)]["counts"][1], 1)}
            for n in MARCH_RAYS
        }))
    return cases, fresh


def cleanup_case(label: str, cfg, snap) -> dict:
    """The whole exact cleanup of the batch in K2's one launch against its
    parts composed around K2 on the pack (``scenes.check_exact_cleanup``),
    and both timed."""
    from elevation_mapping_cupy_torch.ops import raycast
    from elevation_mapping_cupy_torch.ops.geometry import Block

    scenes.check_exact_cleanup(cfg, snap, label)
    whole = Block.whole(cfg.cell_n, cfg.cell_n)
    one = lambda: raycast.visibility_cleanup_exact(*snap, cfg, with_aux=True)  # noqa: E731
    parts = lambda: raycast.visibility_cleanup_exact(*snap, cfg, with_aux=True, block=whole)  # noqa: E731
    res = {"one_launch_ms": _events_ms(one, 20), "composed_ms": _events_ms(parts, 20)}
    res["one_launch_device_ms"], res["one_launch_device_ops_ms"] = _device_ms(one, 20)
    res["composed_device_ms"], _ = _device_ms(parts, 20)
    log("cleanup check: " + json.dumps({"case": label, **res}))
    return res


def phase_march_batch() -> list:
    """K2 at the cell datagen_exact.b64_ep8's shape: one launch for B = 64
    maps of BATCH_POINTS rays (70 steps, gated), on fresh maps (the first
    step of an episode: no cell is old enough to be hit, and at this density
    no ray crosses an invalid cell, so nothing is written) and on maps of 8
    steps aged past the recency gate (cells hit, upper bounds written)."""
    cases = []
    for steps, aged in ((1, False), (8, True)):
        cfg, _, _, args, snap = scenes.datagen_exact_step(64, BATCH_POINTS, "cuda", steps=steps, aged=aged)
        label = f"exact march B=64 N={BATCH_POINTS} gated {'aged, 8 steps' if aged else 'fresh maps'}"
        cases.append(march_case(label, cfg, args, True, aged, writes_ub=aged))
        cases[-1]["cleanup"] = cleanup_case(label, cfg, snap)
        del args, snap
    return cases


# each path's launches of each kernel: a polar update or step, and an
# exact one
PATH_LAUNCHES = {"scatter_add_streams": 3, "exact_march": 0, "dilation_fill": 1, "polar_evaluate": 1,
                 "polar_scan": 1, "points_associate": 1, "points_fuse": 1}
EXACT_PATH_LAUNCHES = {"scatter_add_streams": 2, "exact_march": 1, "dilation_fill": 1, "polar_evaluate": 0,
                       "polar_scan": 0, "points_associate": 1, "points_fuse": 1}


def _counted(regs, tag: str, fn, want=PATH_LAUNCHES):
    """Runs ``fn`` with every kernel's count at 0 before it; fails unless
    the path launched each kernel as ``want`` says. Returns the counts and
    what ``fn`` returned."""
    for kern in regs.values():
        kern.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in regs.items()}
    scenes.check_launches(tag, launches, 1, want)
    return launches, out


def robot_frame(regs) -> dict:
    """The robot's MappingService on the deployed map: a warm-up frame, then
    one counted frame, each of MAIN_POINTS raw PointCloud2-style records;
    the same frames through the CPU port's service."""
    from elevation_mapping_cupy_torch.runtime.service import MappingService

    rng = np.random.default_rng(12)
    frames = []
    for k in range(2):
        R, t, pos = scenes.robot_pose(k)
        frames.append((R, t, pos, scenes.raw_records(scenes.scene_cloud(rng, MAIN_POINTS, R, t), rng)))

    def frame(svc, k):
        R, t, pos, raw = frames[k]
        svc.update_pose(pos, R)
        if not svc.enqueue_raw_pointcloud(raw, MAIN_POINTS, scenes.POINT_STEP, [0, 4, 8], ["x", "y", "z"], R, t,
                                          stamp=0.1 * k):
            raise AssertionError(f"robot frame: the ring rejected frame {k}")
        if svc.spin_once(now=0.1 * (k + 1)) != 1:
            raise AssertionError(f"robot frame: frame {k} was not mapped")

    maps = {}
    for dev in ("cuda", "cpu"):
        svc = MappingService.from_settings(scenes.deployed_config(), scenes.DEPLOYED_EXTRAS, device=dev)
        svc.enable_raw_ingest()
        frame(svc, 0)
        if dev == "cuda":
            launches, _ = _counted(regs, "robot frame", lambda: frame(svc, 1))
        else:
            frame(svc, 1)
        maps[dev] = svc.mapper.get_layers(scenes.LAYERS)
    return {"points": MAIN_POINTS, "launches": launches,
            "cpu_compare": scenes.compare_layers("robot frame", maps["cuda"], maps["cpu"])}


def datagen_step(regs, b: int) -> dict:
    """bench_maps' step of ``b`` maps of BATCH_POINTS points on the default
    map: a warm-up step, then one counted step; the same two steps on the
    CPU port."""
    from elevation_mapping_cupy_torch import MapConfig
    from elevation_mapping_cupy_torch.nn.traversability import DEFAULT_WEIGHT_FILE, load_weights_npz
    from elevation_mapping_cupy_torch.parallel import batched_update, init_batch
    from elevation_mapping_cupy_torch.runtime import datagen
    from elevation_mapping_cupy_torch.state import state_to_numpy

    cfg = MapConfig(max_points=BATCH_POINTS)
    pts, t, _ = datagen.make_batch_clouds(datagen.make_generator(0, "cuda"), b, cfg.cell_n, cfg.resolution,
                                          BATCH_POINTS)
    inputs = (pts, torch.ones((b, BATCH_POINTS), dtype=torch.bool, device="cuda"),
              torch.eye(3, device="cuda").expand(b, 3, 3).contiguous(), t, torch.zeros(b, device="cuda"))
    states = {}
    for dev in ("cuda", "cpu"):
        pts_, mask, R, t_, z = (x.to(dev) for x in inputs)
        w = load_weights_npz(DEFAULT_WEIGHT_FILE).to(dev)  # Module.to moves in place: a copy a device
        step = lambda st: batched_update(st, pts_, mask, R, t_, z, z, w, cfg)  # noqa: E731
        first = step(init_batch(cfg, b, dev))
        if dev == "cuda":
            launches, states[dev] = _counted(regs, f"datagen step B={b}", lambda: step(first))
        else:
            states[dev] = step(first)
    return {"B": b, "points_per_map": BATCH_POINTS, "launches": launches,
            "cpu_compare": scenes.share_within(f"datagen step B={b}", state_to_numpy(states["cuda"]),
                                               state_to_numpy(states["cpu"]), scenes.CMP_ATOL, scenes.CMP_MIN_SHARE)}


def datagen_exact_step(regs, b: int) -> dict:
    """A step of ``b`` maps of BATCH_POINTS points with the exact cleanup,
    on maps of 7 steps aged past the recency gate; the same step on the
    CPU port."""
    from elevation_mapping_cupy_torch.nn.traversability import default_weights
    from elevation_mapping_cupy_torch.parallel import batched_update
    from elevation_mapping_cupy_torch.state import MapState, state_to_numpy

    cfg, args, state, _, _ = scenes.datagen_exact_step(b, BATCH_POINTS, "cuda", steps=8, aged=True)
    launches, out = _counted(regs, f"datagen exact step B={b}", lambda: batched_update(state, *args),
                             EXACT_PATH_LAUNCHES)
    on_cpu = batched_update(MapState(*(x.cpu() for x in state)), *(x.cpu() for x in args[:6]), default_weights(),
                            cfg)
    return {"B": b, "points_per_map": BATCH_POINTS, "launches": launches,
            "cpu_compare": scenes.share_within(f"datagen exact step B={b}", state_to_numpy(out),
                                               state_to_numpy(on_cpu), scenes.CMP_ATOL, scenes.CMP_MIN_SHARE)}


def phase_paths(regs) -> dict:
    paths = {"robot_frame": robot_frame(regs)}
    for b in BATCH_SIZES:
        paths[f"datagen_b{b}_step"] = datagen_step(regs, b)
    paths["datagen_exact_b64_step"] = datagen_exact_step(regs, 64)
    log("paths: " + json.dumps({k: v["launches"] for k, v in paths.items()}))
    return paths


def _timed_cases(cases: list, keys) -> list:
    return [{k: c[k] for k in keys} for c in cases]


def kernels_line(scatter_cases: list, march_cases: dict, dilation_cases: list, polar_cases: list,
                 scan_cases: list, paths: dict, batch_cases: list, stage_cases: list) -> dict:
    """One entry per kernel. K1's numbers are those of one robot update's
    three launches at the main path's cloud size (error counting, fusion,
    cube), summed, with every timed case under ``cases``; its
    ``max_abs_err`` is the largest of them. K2's are those of the gated march
    of MAIN_POINTS rays (the router's first choice). The dilation's, the
    polar evaluation's, the polar scan's, the association's and the
    fusion's are those of the robot's update, with every case under
    ``cases``. ``launches`` is the kernel's
    launches in the robot's counted frame (the main path), ``launches_by_path`` those in each path
    of the paths phase, each counted from 0. ``ms`` is the call as its caller pays for it, ``device_ms`` the device's
    own time."""
    march = march_cases[(MAIN_POINTS, True)]
    robot = scatter_cases[:3]
    total = lambda key: sum(s[key] for s in robot)  # noqa: E731
    common = ("case", "max_abs_err", "kernel_ms", "device_ms", "bound_ms", "plain_ms", "library_ms")

    def entry(name, source, replaces, function, max_err, head, cases):
        return {"name": name, "route": "cuda", "source": f"elevation_mapping_cupy_torch/csrc/{source}",
                "replaces": replaces, "function": function, "checked": True,
                "launches": paths["robot_frame"]["launches"][name],
                "launches_by_path": {path: res["launches"][name] for path, res in paths.items()},
                "max_abs_err": max_err, "ms": head["kernel_ms"], "device_ms": head["device_ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": head.get("bound_by", "bytes"),
                "library_ms": head["library_ms"], "cases": cases}

    def stage_entry(name, function):
        cases = [c for c in stage_cases if c["kernel"] == name]
        return entry(name, "point_stages.cu", None, function, 0.0, cases[0],
                     _timed_cases(cases, ("case", "B", "N", "kernel_ms", "device_ms", "bound_ms", "plain_ms")))

    k1_head = {key: total(key) for key in ("kernel_ms", "device_ms", "plain_ms", "bound_ms", "library_ms")}
    return {"kernels": [
        entry("scatter_add_streams", "scatter_add.cu", "elevation_mapping_cupy_tpu/ops/pallas_scatter.py:142", "_kernel",
              max(c["max_abs_err"] for c in scatter_cases), k1_head,
              _timed_cases(scatter_cases, common + ("path",))),
        entry("exact_march", "exact_march.cu", "scripts/probe_pallas_gather.py:38",
              "k_take, k_take2, k_scat, k_smin, k_sort, k_taa, k_taa2, k_take2d",
              max(c["max_abs_err"] for c in list(march_cases.values()) + batch_cases), march,
              _timed_cases(list(march_cases.values()) + batch_cases, common + ("bound_by",))),
        entry("dilation_fill", "dilation_fill.cu", None, "ops/stencil.py::dilation_fill_reference (the offset loop)",
              0.0, dilation_cases[0], _timed_cases(dilation_cases, ("case", "B", "size", "kernel_ms", "device_ms",
                                                                    "bound_ms", "plain_ms"))),
        entry("polar_evaluate", "polar_evaluate.cu", None, "ops/raycast.py::_polar_evaluate",
              max(c["max_rel_err"] for c in polar_cases), polar_cases[0],
              _timed_cases(polar_cases, ("case", "B", "R", "S", "pyramid", "kernel_ms", "device_ms",
                                         "device_ms_per_map", "bound_ms", "plain_ms", "plain_ms_per_map"))),
        entry("polar_scan", "polar_scan.cu", None, "ops/raycast.py::_polar_scan", 0.0, scan_cases[0],
              _timed_cases(scan_cases, ("case", "B", "R", "S", "kernel_ms", "device_ms", "device_ms_per_map",
                                        "bound_ms", "plain_ms", "plain_ms_per_map"))),
    ] + [stage_entry(name, function) for name, function in (("points_associate", "ops/point_stages.py::_associate"),
                                                            ("points_fuse", "ops/point_stages.py::_fuse"))]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json", metavar="PATH", help="also write every measured number of the run to PATH")
    args = parser.parse_args(argv)
    t0 = time.perf_counter()

    def timed(phase, fn, *fn_args):
        t = time.perf_counter()
        out = fn(*fn_args)
        log(f"phase {phase}: {time.perf_counter() - t:.1f} s")
        return out

    name, count, smi = phase_device()
    regs = timed("build", phase_build)
    cfg = scenes.deployed_config()
    scatter_cases = timed("kernels (scatter)", phase_scatter, cfg)
    dilation_cases = timed("kernels (dilation)", phase_dilation, cfg)
    scan_cases, polar_cases = timed("kernels (polar scan and evaluation)", phase_polar, cfg)
    stage_cases = timed("kernels (point stages)", phase_point_stages, cfg)
    march_cases, fresh_cases = timed("kernels (exact march)", phase_march, cfg)
    batch_cases = timed("kernels (exact march, batched)", phase_march_batch)
    paths = timed("paths", phase_paths, regs)
    log(f"total: {time.perf_counter() - t0:.1f} s")
    line = kernels_line(scatter_cases, march_cases, dilation_cases, polar_cases, scan_cases, paths, batch_cases,
                        stage_cases)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({
                "card": smi, "kernels_line": line, "scatter_cases": scatter_cases, "dilation_cases": dilation_cases,
                "polar_cases": polar_cases, "scan_cases": scan_cases, "stage_cases": stage_cases,
                "march_cases": list(march_cases.values()) + list(fresh_cases.values()) + batch_cases,
                "paths": paths,
            }, f, indent=1)
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
