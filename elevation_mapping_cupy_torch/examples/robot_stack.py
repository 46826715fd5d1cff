"""End-to-end robot stack: config-driven service -> map -> plane decomposition.

Port of ``examples/robot_stack.py``, the full deployment shape of the
reference system in one script:
  1. a YAML config (the reference's core_param.yaml + subscribers/publishers
     blocks) wires a MappingService with TWO sensors — a LiDAR publishing a
     semantic channel and an RGB camera — with per-channel fusions,
  2. simulated frames stream through the queues; spin_once drives the
     update/variance/time timers and the fps-limited publishers exactly like
     the reference node's ros::Timers,
  3. services answer: get_submap in a ROTATED request frame
     (get_raw_submap), check_safety polygons, drift for the map->odom TF,
  4. the published elevation feeds the plane-decomposition pipeline
     (the reference's separate convex_plane_decomposition_ros node) and a
     convex foothold polygon is grown at a query point.

    python -m elevation_mapping_cupy_torch.examples.robot_stack [--device cpu]

Reading the YAML needs PyYAML. Where it is not installed, pass the same
configuration already loaded: ``run(settings=settings())`` (a literal that
the tests hold equal to what ``CONFIG`` loads to).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

from ..config import MapConfig
from ..planeseg.pipeline import PlaneDecompositionPipeline
from ..runtime.service import MappingService, SensorFrame
from . import add_device_argument, resolve, sync

CONFIG = """
resolution: 0.05
map_length: 4.0
max_ray_length: 1.0
max_points: 20000
semantic_layers: [grass, rgb]
pointcloud_channel_fusions:
  default: class_average
image_channel_fusions:
  rgb: color
  default: exponential
update_variance_fps: 5.0
time_interval: 0.2
subscribers:
  front_lidar:
    topic_name: /lidar/points
    data_type: pointcloud
    channels: [grass]
  color_cam:
    topic_name: /camera/rgb/image_raw
    camera_info_topic_name: /camera/rgb/camera_info
    data_type: image
publishers:
  elevation_map_raw:
    layers: [elevation, traversability, grass, rgb]
    basic_layers: [elevation]
    fps: 10.0
"""
TICKS = 10
POINTS = 20000
LIDAR_R = np.eye(3, dtype=np.float32)
LIDAR_T = np.array([0, 0, 0.8], np.float32)
FLAT_POLY = np.array([[-1.2, -1.2], [-0.4, -1.2], [-0.4, -0.4], [-1.2, -0.4]], np.float32)
EDGE_POLY = np.array([[0.0, -0.4], [1.0, -0.4], [1.0, 0.4], [0.0, 0.4]], np.float32)
MAP_LAYERS = ("elevation", "variance", "traversability", "grass", "rgb")


def settings():
    """What ``load_config_with_extras`` makes of ``CONFIG``: the MapConfig
    and the ROS-layer extras."""
    cfg = MapConfig(
        resolution=0.05, map_length=4.0, max_ray_length=1.0, max_points=20000, time_interval=0.2,
        semantic_layers=("grass", "rgb"),
        pointcloud_channel_fusions=(("default", "class_average"),),
        image_channel_fusions=(("default", "exponential"), ("rgb", "color")),
    )
    extras = {
        "update_variance_fps": 5.0,
        "subscribers": {
            "front_lidar": {"topic_name": "/lidar/points", "data_type": "pointcloud", "channels": ["grass"]},
            "color_cam": {"topic_name": "/camera/rgb/image_raw",
                          "camera_info_topic_name": "/camera/rgb/camera_info", "data_type": "image"},
        },
        "publishers": {
            "elevation_map_raw": {"layers": ["elevation", "traversability", "grass", "rgb"],
                                  "basic_layers": ["elevation"], "fps": 10.0},
        },
    }
    return cfg, extras


def terrain_height(x, y):
    """Ground plane with a raised platform (the foothold target)."""
    h = 0.01 * np.sin(3.0 * x)
    h = np.where((np.abs(x - 0.6) < 0.45) & (np.abs(y) < 0.5), h + 0.25, h)
    return h.astype(np.float32)


def lidar_frame_raw(rng, n: int = POINTS):
    """Simulated LiDAR scan as RAW interleaved sensor bytes (PointCloud2
    layout: x,y,z,grass float32 records) — exercised through the native
    ring + deinterleave ingest path. Points are in the SENSOR frame
    (world = R @ p + t, sensor at z=0.8)."""
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = rng.uniform(-1.9, 1.9, n)
    pts[:, 1] = rng.uniform(-1.9, 1.9, n)
    world_z = terrain_height(pts[:, 0], pts[:, 1]) + rng.normal(0, 0.005, n)
    pts[:, 2] = world_z - 0.8
    pts[:, 3] = np.where(world_z < 0.1, 0.9, 0.1)  # ground is grassy
    return pts.tobytes(), n


def camera_frame() -> SensorFrame:
    """Overhead RGB camera: green ground, brick platform."""
    H, W = 48, 64
    img = np.zeros((3, H, W), np.float32)
    img[1] = 180.0
    img[0, :, 40:] = 150.0  # the platform side of the image reads brick-ish
    K = np.array([[40, 0, W / 2], [0, 40, H / 2], [0, 0, 1]], np.float32)
    R = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)  # looking down
    return SensorFrame(
        kind="image", channels=(), data=img,
        R=R, t=np.array([0.0, 0.0, 1.5], np.float32),
        K=K, D=np.zeros(5, np.float32),
    )


def make_service(device, loaded=None) -> MappingService:
    """The service from ``CONFIG`` (PyYAML reads it), or from ``loaded``, the
    (config, extras) pair already loaded."""
    if loaded is not None:
        return MappingService.from_settings(*loaded, device=device)
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        f.write(CONFIG)
        cfg_path = f.name
    try:
        return MappingService.from_config(cfg_path, device=device)
    finally:
        os.unlink(cfg_path)


def run(device=None, settings=None) -> dict:
    """Stream the sensors through the service for ``TICKS`` ticks, answer
    the services and decompose the published elevation. Returns what the
    example prints, the final map layers, the published layers and each
    spin's seconds (ended by a synchronise)."""
    dev = resolve(device)
    rng = np.random.default_rng(0)
    svc = make_service(dev, settings)
    published = {}
    svc.set_publisher_callback("elevation_map_raw", published.update)

    # stream the ticks of both sensors; the lidar arrives as raw interleaved
    # bytes through the native ring (the reference's PointCloud2 hot loop)
    svc.enable_raw_ingest(capacity=8, slab_bytes=2 << 20)
    spin_s = []
    for i in range(TICKS):
        raw, n_pts = lidar_frame_raw(rng)
        svc.enqueue_raw_pointcloud(raw, n_pts, 16, [0, 4, 8, 12], [], LIDAR_R, LIDAR_T,
                                   stamp=0.2 * i, subscriber="front_lidar")
        if i % 3 == 0:
            svc.enqueue(camera_frame(), subscriber="color_cam")
        t0 = time.perf_counter()
        svc.spin_once(now=0.2 * (i + 1))
        sync(dev)
        spin_s.append(time.perf_counter() - t0)
    out = {
        "sensors": sorted(svc.subscribers), "fps": svc.stats.pointcloud_process_fps,
        "dropped": svc.stats.frames_dropped, "ring": svc._ring.stats(), "spin_s": spin_s,
        "published": dict(published), "layers": svc.mapper.get_layers(list(MAP_LAYERS)),
    }

    # services — submap in a 45-degree-rotated request frame
    th = np.pi / 4
    Rf = np.array([[np.cos(th), -np.sin(th), 0],
                   [np.sin(th), np.cos(th), 0],
                   [0, 0, 1]], np.float64)
    out["submap"] = svc.get_submap(np.zeros(2), (1.5, 1.5), ["elevation"],
                                   frame_transform=(Rf, np.zeros(3)))["elevation"]
    # result[1] is the polygon's mean UNtraversability (the reference's
    # masked-untraversability, traversability_polygon.py:10-19)
    out["safety"] = {name: svc.check_safety([poly])[0][:2]
                     for name, poly in (("flat ground", FLAT_POLY), ("platform edge", EDGE_POLY))}
    out["drift"] = svc.map_to_odom_error()

    # plane decomposition on the published elevation (the sidecar node)
    pipe = PlaneDecompositionPipeline(resolution=svc.mapper.resolution, device=dev)
    elev = published["elevation"]
    out["terrain"] = terrain = pipe.update(elev)
    # foothold on the platform top: locate it from the data (the pipeline's
    # frame with map_origin=(0,0) is x=-row*res, y=-col*res)
    rows, cols = np.where(np.nan_to_num(elev, nan=-1.0) > 0.15)
    query = np.array([-rows.mean() * pipe.resolution, -cols.mean() * pipe.resolution])
    out["foothold"] = pipe.convex_approximation(terrain, query, n_vertices=12)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m elevation_mapping_cupy_torch.examples.robot_stack",
                                 description=__doc__.split("\n\n")[0])
    add_device_argument(ap)
    args = ap.parse_args(argv)
    r = run(args.device)
    print(f"service up: sensors={r['sensors']}")
    print(f"pointcloud fps: {r['fps']:.1f}, dropped: {r['dropped']}, ring: {r['ring']}")
    print(f"published layers: {sorted(r['published'])}")
    e = r["submap"]
    print(f"rotated-frame submap: {e.shape}, height range [{np.nanmin(e):.2f}, {np.nanmax(e):.2f}] m")
    for name, (is_safe, untrav) in r["safety"].items():
        print(f"check_safety[{name}]: safe={is_safe} untraversability={untrav:.2f}")
    print(f"map->odom drift: {r['drift']:+.4f} m")
    print(f"planar regions: {len(r['terrain'].regions)}")
    poly = r["foothold"]
    if poly is not None:
        a = poly - poly.mean(0)
        b = np.roll(poly, -1, 0) - poly.mean(0)
        area = abs((a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]).sum() / 2)
        print(f"foothold polygon: convex {len(poly)}-gon, area ~{area:.3f} m^2")
    else:
        print("foothold polygon: none")
    return 0


if __name__ == "__main__":
    sys.exit(main())
