"""Profiling harness — parity with the reference's cProfile __main__ block
(elevation_mapping.py:925-967): N iterations of input + normals + move +
publish + polygon check, with per-stage wall times and an optional
torch.profiler trace. The port's counterpart of
``python -m elevation_mapping_cupy_tpu.profile`` (same flags and table).

Usage:
    python -m elevation_mapping_cupy_torch.profile [--points 100000] [--iters 50]
        [--trace DIR] [--cpu]

Runs on the CUDA card unless ``--cpu`` is given; each stage's clock stops
after ``torch.cuda.synchronize()``. Under the stage table it prints the
program's own spans over the timed iterations (``tracing.summary()``): per
span, the count, the median host ms, the self ms (without its child spans)
and, while a profiler runs, the stream ms of the update's stages.
``--trace DIR`` writes a Chrome trace of the timed iterations to
``DIR/trace.json``, where the program's spans are ranges of their own.
"""

from __future__ import annotations

import argparse
import os
import time
from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np
import torch

# the cloud's columns, and the layers published each iteration
CHANNELS = ["x", "y", "z", "rgb", "grass", "tree", "people"]
LAYERS = ["elevation", "variance", "traversability", "upper_bound", "rgb"]


def profile_config(points: int):
    """The default ``MapConfig`` with room for ``points`` points, rgb fused
    as colour and every other channel by class_bayesian."""
    from .config import MapConfig

    return MapConfig(max_points=points, pointcloud_channel_fusions=(("rgb", "color"), ("default", "class_bayesian")))


def make_points(rng: np.random.Generator, points: int) -> np.ndarray:
    """A uniform cloud of ``points`` rows of CHANNELS within 4 m, heights
    -0.2 to 0.5 m."""
    pts = rng.uniform(-4, 4, (points, len(CHANNELS))).astype(np.float32)
    pts[:, 2] = rng.uniform(-0.2, 0.5, points)
    return pts


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    """Run the profile; prints the stage table and returns, per stage, its
    mean and p99 in ms."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--trace", type=str, default=None, help="directory for a torch.profiler Chrome trace")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)

    from . import tracing
    from .mapper import ElevationMap

    em = ElevationMap(profile_config(args.points), device="cpu" if args.cpu else None)
    cuda = em.device.type == "cuda"
    rng = np.random.default_rng(123)
    R = np.eye(3, dtype=np.float32)
    channels, layers = CHANNELS, LAYERS
    data = np.zeros((em.cell_n - 2, em.cell_n - 2), np.float32)
    polygon = np.array([[0, 0], [2, 0], [0, 2]], np.float32)
    result = np.zeros(3)

    def sync():
        if cuda:
            torch.cuda.synchronize(em.device)

    stage = defaultdict(list)

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        stage[name].append(time.perf_counter() - t0)
        return out

    # warmup — run EVERY timed stage once: the first input_pointcloud grows
    # the semantic layers, and the first call of each stage sets up the
    # card's kernels and caches; without this the table mixes them in
    em.input_pointcloud(make_points(rng, args.points), channels, R, np.array([0, 0, 0.6], np.float32), 0, 0)
    em.update_normal()
    em.move_to(np.zeros(3), R)
    for layer in layers:
        em.get_map_with_name_ref(layer, data)
    em.get_polygon_traversability(polygon, result)

    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=activities)
        prof.__enter__()
    sync()
    t_start = time.perf_counter()
    since_ns = time.perf_counter_ns()
    for i in range(args.iters):
        pts = make_points(rng, args.points)
        t = np.array([i * 0.01, i * 0.02, 0.6], np.float32)
        timed("input_pointcloud", lambda: em.input_pointcloud(pts, channels, R, t, 0, 0))
        timed("update_normal", lambda: em.update_normal())
        timed("move_to", lambda: em.move_to(np.array([i * 0.01, i * 0.02, i * 0.01]), R))

        def publish():
            for layer in layers:
                em.get_map_with_name_ref(layer, data)

        timed("publish", publish)
        timed("polygon", lambda: em.get_polygon_traversability(polygon, result))
    sync()
    total = time.perf_counter() - t_start
    spans = tracing.summary(tracing.spans(since_ns))
    if prof is not None:
        prof.__exit__(None, None, None)
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace, "trace.json"))

    device = torch.cuda.get_device_name(em.device) if cuda else "cpu"
    print(f"{args.iters} iterations x {args.points} points on {device}: {total:.2f}s "
          f"({args.iters * args.points / total / 1e6:.2f} M pts/s end-to-end)")
    print(f"{'stage':<18}{'mean_ms':>10}{'p99_ms':>10}")
    table = {}
    for name, v in stage.items():
        a = np.asarray(v) * 1e3
        table[name] = {"mean_ms": float(a.mean()), "p99_ms": float(np.percentile(a, 99))}
        print(f"{name:<18}{table[name]['mean_ms']:>10.2f}{table[name]['p99_ms']:>10.2f}")
    print(f"{'span':<26}{'count':>7}{'median_ms':>11}{'self_ms':>10}{'stream_ms':>11}")
    for name, v in spans.items():
        stream = "-" if v["stream_ms"] is None else f"{v['stream_ms'] / v['count']:.3f}"
        print(f"{name:<26}{v['count']:>7}{v['median_ms']:>11.3f}{v['self_ms'] / v['count']:>10.3f}{stream:>11}")
    return table


if __name__ == "__main__":
    main()
