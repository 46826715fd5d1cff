"""Minimal end-to-end demo: synthetic depth sweeps -> elevation map -> exports.

Port of ``examples/minimal_mapping.py``, after the reference's
simple_example turtlebot workflow without ROS: build a map from a few
simulated depth-camera frames over procedural terrain, then export layers,
query polygon safety, and run plane decomposition.

    python -m elevation_mapping_cupy_torch.examples.minimal_mapping [--device cpu]

The terrain and the clouds are made on the device from one seeded
generator: ``runtime.datagen``'s draws (``draw_terrain``, ``draw_cloud``)
and its deterministic work on them (``terrain_from_draws``,
``cloud_from_draws``), which is what ``procedural_terrain`` and
``simulate_depth_cloud`` compute. ``run(draws=...)`` takes other draws (the
tests pass the JAX example's).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import MapConfig
from ..mapper import ElevationMap
from ..planeseg.pipeline import PlaneDecompositionPipeline
from ..runtime import datagen
from . import add_device_argument, resolve

CONFIG = MapConfig(resolution=0.05, map_length=6.0, max_ray_length=2.0, max_points=40_000)
STEPS = 6
POINTS = 40_000
SENSOR_HEIGHT = 0.7
LAYERS = ("elevation", "traversability", "normal_z")
POLYGON = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]], np.float32)


def make_draws(device=None, seed: int = 3) -> Tuple[List[torch.Tensor], List[datagen.CloudDraws]]:
    """The terrain's lattices and each step's cloud draws, from one
    generator on ``device``."""
    gen = datagen.make_generator(seed, resolve(device))
    lattices = datagen.draw_terrain(gen, CONFIG.cell_n)
    return lattices, [datagen.draw_cloud(gen, POINTS) for _ in range(STEPS)]


def robot_position(step: int) -> np.ndarray:
    return np.array([0.15 * step, 0.05 * step, 0.0], np.float32)


def run(device=None, draws=None) -> dict:
    """Map the simulated robot's walk, export, query and decompose. Returns
    the exported layers, the polygon query's result and the planar
    terrain."""
    dev = resolve(device)
    lattices, clouds = make_draws(dev) if draws is None else draws
    cfg = CONFIG
    em = ElevationMap(cfg, device=dev)
    eye = np.eye(3, dtype=np.float32)
    # simulated robot walking over procedural terrain
    terrain = datagen.terrain_from_draws([x.to(dev) for x in lattices], cfg.cell_n)
    for step, d in enumerate(clouds):
        pos = robot_position(step)
        sensor = torch.as_tensor(pos + np.array([0, 0, SENSOR_HEIGHT], np.float32), device=dev)
        cloud, t = datagen.cloud_from_draws(terrain, cfg.resolution, sensor,
                                            datagen.CloudDraws(*(x.to(dev) for x in d)))
        em.input_pointcloud(cloud.cpu().numpy(), ["x", "y", "z"], eye, t.cpu().numpy(), 0.0, 0.0)
        em.move_to(pos, eye)
        em.update_normal()

    layers = {}
    for layer in LAYERS:
        out = np.zeros((em.cell_n - 2, em.cell_n - 2), np.float32)
        em.get_map_with_name_ref(layer, out)
        layers[layer] = out
    result = np.zeros(3)
    em.get_polygon_traversability(POLYGON, result)
    planes = PlaneDecompositionPipeline(cfg.resolution, device=dev).update(layers["elevation"])
    return {"layers": layers, "polygon": result, "planes": planes}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m elevation_mapping_cupy_torch.examples.minimal_mapping",
                                 description=__doc__.split("\n\n")[0])
    add_device_argument(ap)
    args = ap.parse_args(argv)
    r = run(args.device)
    for layer, out in r["layers"].items():
        print(f"{layer:15s} valid={np.isfinite(out).sum():6d} "
              f"range=[{np.nanmin(out):+.2f}, {np.nanmax(out):+.2f}]")
    result = r["polygon"]
    print(f"polygon safety: is_safe={bool(result[0])} trav={result[1]:.3f}")
    print(f"plane decomposition: {len(r['planes'].regions)} planar regions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
