"""End-to-end MEM (multi-modal) mapping demo.

Port of ``examples/semantic_mapping.py``, the whole semantic story in one
script:
  1. a sensor sidecar node back-projects synthetic depth+rgb into a
     structured pointcloud with semantic channels (the reference's
     semantic_sensor PointcloudNode),
  2. the map fuses geometry, RGB colour and class-probability layers from
     the cloud in one update (colour -> ``color``, the rest ->
     ``class_average``),
  3. a camera image updates a semantic layer through the projection and
     occlusion path (``input_image``),
  4. layers export exactly like the reference GridMap publisher.

    python -m elevation_mapping_cupy_torch.examples.semantic_mapping [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import warnings
from typing import Optional, Sequence

import numpy as np

from ..config import MapConfig
from ..mapper import ElevationMap
from ..sensor.pointcloud import PointcloudParameter, PointcloudSensorNode
from . import add_device_argument, resolve

CONFIG = MapConfig(
    resolution=0.1, map_length=4.0, max_ray_length=1.0,
    pointcloud_channel_fusions=(("rgb", "color"), ("default", "class_average")),
    image_channel_fusions=(("rgb", "color"), ("default", "exponential")),
)
LAYERS = ("elevation", "traversability", "rgb", "grass", "obstacle")
MAST = np.array([0.0, 0.0, 0.8], np.float32)
K = np.array([[40, 0, 32], [0, 40, 24], [0, 0, 1]], np.float32)
# the camera looks down: sensor z maps to world -z from the mast height
CAM_R = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)


def synth_frame(h: int = 48, w: int = 64, rng=None):
    """Synthetic depth+rgb camera frame: a tilted ground plane and a box."""
    rng = rng or np.random.default_rng(7)
    ys, xs = np.mgrid[0:h, 0:w]
    depth = 1.5 + 0.8 * (ys / h)                     # ground receding below
    depth[12:30, 22:42] = 1.2                        # a box in front
    depth += rng.normal(0, 0.005, (h, w))
    rgb = np.zeros((3, h, w), np.uint8)
    rgb[1] = 180                                     # grass-green world
    rgb[:, 12:30, 22:42] = np.array([160, 60, 40])[:, None, None]  # brick box
    return depth.astype(np.float32), rgb


def run(device=None) -> dict:
    """Sensor node -> fused cloud update -> image update -> exports.
    Returns the cloud's shape and channels, the exported layers and the
    packed colours' mean red and green."""
    dev = resolve(device)
    em = ElevationMap(CONFIG, device=dev)
    # --- 1+2: sensor node -> multi-modal cloud -> fused map update
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        node = PointcloudSensorNode(
            PointcloudParameter(channels=("grass", "obstacle")),
            semantic_model="random_features",   # swap for a torchvision/DINO name
            device=dev,
        )
    depth, rgb = synth_frame()
    cloud, channels = node(depth, K, rgb=rgb)  # channels names EVERY column
    em.input_pointcloud(cloud, channels, CAM_R, MAST, 0.0, 0.0)

    # --- 3: image update through the projection/occlusion path
    grass_image = rgb[1].astype(np.float32) / 255.0  # fake class probability
    em.input_image([grass_image], ["grass"], CAM_R, MAST, K, np.zeros(5, np.float32))

    # --- 4: exports (identical call shape to the reference)
    layers = {}
    for layer in LAYERS:
        if not em.exists_layer(layer):
            raise AssertionError(f"layer {layer} missing from the map")
        out = np.zeros((em.cell_n - 2, em.cell_n - 2), np.float32)
        em.get_map_with_name_ref(layer, out)
        layers[layer] = out
    # decode the packed rgb layer back to channels for display
    rgb_out = layers["rgb"]
    packed = rgb_out[np.isfinite(rgb_out)].view(np.uint32)
    mean_rg = (float(((packed >> 16) & 255).mean()), float(((packed >> 8) & 255).mean())) if len(packed) else None
    return {"cloud_shape": cloud.shape, "channels": channels, "layers": layers, "mean_rg": mean_rg}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m elevation_mapping_cupy_torch.examples.semantic_mapping",
                                 description=__doc__.split("\n\n")[0])
    add_device_argument(ap)
    args = ap.parse_args(argv)
    r = run(args.device)
    print(f"sensor cloud: {r['cloud_shape']}, channels: {r['channels']}")
    for layer, out in r["layers"].items():
        print(f"layer {layer:16s} finite cells: {int(np.isfinite(out).sum())}")
    if r["mean_rg"] is not None:
        red, green = r["mean_rg"]
        print(f"rgb layer: mean R={red:.0f} G={green:.0f} (green-dominant world: {bool(green > red)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
