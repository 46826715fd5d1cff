"""Convex plane decomposition demo — the ConvexApproximationDemoNode analogue.

Port of ``examples/plane_decomposition_demo.py``: synthetic stepped terrain
-> ``PlaneDecompositionPipeline`` on the device -> per-query convex
approximation, printed as text, an overlay image, and the pipeline's
per-stage timer table.

    python -m elevation_mapping_cupy_torch.examples.plane_decomposition_demo [--device cpu] [--out PNG]

The overlay goes to ``--out`` (default: a new temporary directory).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Optional, Sequence

import numpy as np

from ..planeseg import draw
from ..planeseg.pipeline import PlaneDecompositionPipeline
from . import add_device_argument, resolve

RESOLUTION = 0.04
# world frame: x = -row*res, y = -col*res from the map origin
QUERIES = np.array([[-2.8, -2.6], [-2.8, -4.6], [-5.9, -5.9]], np.float32)


def make_terrain(n: int = 160) -> np.ndarray:
    """Stepped terrain with a ramp and sensor holes."""
    rng = np.random.default_rng(3)
    h = np.zeros((n, n), np.float32)
    h[40:100, 30:130] = 0.25                       # platform
    h[110:150, 20:70] = 0.12                       # lower step
    ramp = np.linspace(0.0, 0.25, 30, dtype=np.float32)
    h[40:100, 100:130] = ramp[None, :]             # ramp onto the platform
    h += rng.normal(0, 0.0015, (n, n)).astype(np.float32)
    h[rng.random((n, n)) < 0.015] = np.nan         # dropouts
    return h


def polygon_area(poly: np.ndarray) -> float:
    return 0.5 * abs(float(np.sum(poly[:, 0] * np.roll(poly[:, 1], -1) - np.roll(poly[:, 0], -1) * poly[:, 1])))


def run(device=None, out: Optional[str] = None, repeats: int = 5) -> dict:
    """Decompose the terrain, write the overlay to ``out``, grow a convex
    foothold at each query, then time ``repeats`` more updates. Returns the
    terrain, the overlay's path and marker count, the polygons (None where
    no planar region was found) and the timing table."""
    dev = resolve(device)
    h = make_terrain()
    pipe = PlaneDecompositionPipeline(resolution=RESOLUTION, device=dev)
    terrain = pipe.update(h)
    if out is None:
        out = os.path.join(tempfile.mkdtemp(prefix="decomposition_"), "decomposition_overlay.png")
    # debug rendering (Draw.cpp / RosVisualizations parity): region
    # boundaries + holes + insets over the elevation image
    draw.save_decomposition_overlay(out, terrain.elevation, terrain.regions, terrain.resolution, terrain.map_origin)
    n_markers = len(draw.boundary_markers(terrain.regions)) - 1
    # project query points and grow convex footholds (the demo node's loop)
    polygons = [pipe.convex_approximation(terrain, q, n_vertices=12) for q in QUERIES]
    # steady-state per-stage timings (the first update excluded)
    pipe._stats = {}
    for _ in range(repeats):
        pipe.update(h)
    return {"terrain": terrain, "overlay": out, "n_markers": n_markers, "polygons": polygons,
            "timing_report": pipe.timing_report()}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m elevation_mapping_cupy_torch.examples.plane_decomposition_demo",
                                 description=__doc__.split("\n\n")[0])
    add_device_argument(ap)
    ap.add_argument("--out", default=None, help="overlay image path (default: in a new temporary directory)")
    args = ap.parse_args(argv)
    r = run(args.device, args.out)
    terrain = r["terrain"]
    print(f"regions: {len(terrain.regions)}")
    for i, reg in enumerate(terrain.regions):
        nrm = np.asarray(reg.normal).round(3)
        sup = np.asarray(reg.support).round(3)
        print(
            f"  region {i}: label={reg.label}, support={sup.tolist()}, "
            f"normal={nrm.tolist()}, boundary_pts={len(reg.boundary_with_holes.boundary)}"
        )
    print(f"overlay written: {r['overlay']} ({r['n_markers']} boundary markers)")
    for q, poly in zip(QUERIES, r["polygons"]):
        if poly is None:
            print(f"query {q.tolist()}: no planar region")
            continue
        print(
            f"query {q.tolist()}: convex {len(poly)}-gon, area {polygon_area(poly):.3f} m^2, "
            f"first vertex {poly[0].round(3).tolist()}"
        )
    print()
    print(r["timing_report"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
