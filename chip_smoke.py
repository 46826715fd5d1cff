#!/usr/bin/env python3
"""Drive the PyTorch port (``elevation_mapping_cupy_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any fault:

1. device  - the card's name, count and power limit; no card, no run.
2. build   - every CUDA kernel of the port, built from ``csrc/`` with nvcc
             (one process per source, all started together).
3. kernels - K1 against its plain PyTorch version on the card, at the main
             path's shapes (the dense-map scatters take its shared-memory
             path, the polar cube its global path) and at the semantic
             fusions' (3 and 8 feature streams, the colour's integer streams,
             class_max's 262144 points over 1305728 bins) and plane
             decomposition's (10 moment streams and the bad-cell count of
             bench_planeseg's 40804 labelled cells over 65 bins, one map
             and a batch of 16) and the profile entry point's (the default
             MapConfig: 100000 points padded to 131072, its map and its
             polar cube's 4718592 bins, colour and class_bayesian) and the
             batched phase's (its three launches at B = 1, 16 and 64 maps
             of 100000 points) and the semantic sensor path's (a 480x640
             depth frame's points padded to 524288: geometry and the
             class_average over three channels), with the call's time
             (CUDA events around the wrapper), the device's own time for it
             (torch.profiler), the plain version's, one PyTorch library
             call's, and the bound (bytes over 3.35 TB/s).
4. main    - ``ElevationMap(deployed config, device="cuda")`` with the
             shipped weights takes 20 updates of a seeded synthetic scene of
             131072 points while the robot moves (``move_to``); the polar
             cleanup runs, so every update must launch K1 exactly 3 times and
             K2 never. The last 2 updates are rerun from the same state on
             ``device="cpu"`` and compared layer by layer. Then per-update
             latency and points/s at 10k, 131072 and 1M points, the peak
             device memory, and a torch.profiler view of where one update's
             device time goes.
5. march   - K2 against its plain version on the card at the deployed
             shapes (202x202 cells, 353 steps), on the main phase's map aged
             past the recency gate, for 131072 and 1048576 rays of the scene,
             gate on and off: hit counts, upper bounds and segment counts
             equal, the decrement within 2e-4 relative; its time (call and
             device), the plain version's, and the bound from the work the
             plain version tallied on the same inputs. The same four cases
             on the map before it is aged (no cell can be hit yet) give the
             gated march against the flat one on a fresh map.
6. exact   - the same deployed config with ``raycast_mode="exact"``: 8
             updates of 131072 points with the gated/flat router live (353
             steps x 131072 points >= 1 << 20); every update must launch K2
             once and K1 twice. The last 2 updates are rerun on the CPU and
             compared layer by layer; then latency at 131072 and 1M points
             and the router's choices.
7. replay  - a 3-frame log written with ``LogWriter`` and replayed through
             ``runtime.replay.replay(device="cuda")``, compared with the same
             replay on the CPU.
8. semantic - the deployed config with ``configs/semantic_mem.yaml``'s layers
             and fusion tables (rgb -> color, three class channels ->
             class_average): 8 updates of 131072 points of 3 + 4 columns
             while the robot moves, 5 K1 launches each (3 of the geometry,
             one of 4 integer streams for the colour, one of 3 value streams
             for the classes). Then a second map whose table sends one
             channel each to average, bayesian_inference and class_bayesian
             and two to class_max: 3 updates, 7 K1 launches each, the
             class_max one over 32 x 202 x 202 bins on K1's global path. The
             last update of each map is rerun on the CPU port from the same
             state: float layers within 1e-4, packed colours and class ids
             bit for bit, on 99.9 % of cells. Latency, points/s, a profile,
             and the packed layers' round trips on the card.
9. image   - on the first semantic map, ``input_image`` with a 4-plane
             480x640 image (rgb -> color, mask -> exponential) from a camera
             looking down from 1.5 m, 0.6 m ahead of the map's centre: 10 calls with the shadow
             occlusion, 2 with the Bresenham walk, each compared with the
             CPU port (valid on 99.5 % of cells, fused layers on the cells
             valid in both); latency and device time of each mode. The image
             path launches neither kernel.
10. plugins - the first semantic map with ``configs/plugin_config.yaml``'s
             eight plugins (a literal: the card's machine has no PyYAML)
             plus semantic_filter and features_pca over its class layers:
             2 more updates (5 K1 launches each), then every plugin layer
             through ``get_map_with_name_ref`` and all of them through
             ``get_layers``, each against the CPU port from the same state
             (float layers within 1e-4 on 99.9 % of cells with NaN where
             the CPU has NaN, semantic_filter bit for bit, features_pca
             channel by channel equal or mirrored within 1); a polygon
             query (the JAX package's profile.py triangle about the map's
             centre) and ``initialize_map`` on a fresh map, each against the
             CPU port.
             Exports, query and initialisation launch neither kernel.
             Latency (median and p90 of 10 calls) and device time of each
             export and of the query, and min_filter at s=5, 5 iterations
             beside the YAML's s=1, 2. Says whether cv2 is installed
             (inpainting and erosion take their cv2 branch if it is).

11. planeseg - ``PlaneDecompositionPipeline(0.04, device="cuda")`` on
             bench.py::bench_planeseg's scene (202x202 at 0.04 m, two raised
             boxes, 2 mm noise, 2 % NaN holes, seed 0): one warm-up and 10
             ``update`` calls, 2 K1 launches each (the per-label moments and
             the "any bad cell" count); median and p90 of
             ``timings["total"]`` and of the host clock, device ms and
             operations per update, the connected components' rounds and
             the ``timing_report`` table. Checks: labels equal to the CPU
             port's (the differing cells are printed), the same regions with
             plane normals and supports within 1e-5, filtered map,
             elevation and smooth layer within 1e-5 on 99.9 % of cells, a
             second card update's labels identical. Then ``update_batch`` at
             B = 16 (bench.py's noise per map), ms per map and 2 K1 launches
             a call, maps 0 and 15 equal to their own ``update``. K1 runs
             only at shapes the kernels phase checked; the rounds of each
             fixed-point loop are printed.
12. profile - ``elevation_mapping_cupy_torch.profile.main`` (10 iterations of
             100000 points at the default ``MapConfig``): its stage table,
             5 K1 launches per update (its warm-up included) at shapes the
             kernels phase checked, then one update of that map on the card
             compared with the CPU port from the same state.
13. batched - ``parallel.batched_update`` (bench.py::bench_maps' path) at the
             default ``MapConfig`` with the shipped CNN weights: B = 64 maps
             of 100000 points each from ``runtime.datagen.make_batch_clouds``
             on the card (seed 0), one warm-up and 10 steps, then the same
             at B = 1 and B = 16: step ms (median, p90), maps/s, device ms,
             operations and busy share per step (torch.profiler), peak
             device memory, and K1 launched 3 times per step whatever B is,
             only at shapes the kernels phase checked (it times K1 at the
             batched shapes too). At B = 64: maps 0 and 63 equal their own
             per-map ``update_pointcloud`` on the card (1e-5 on 99.9 % of
             cells), maps 0-3 rerun as a B = 4 batch on the CPU port equal
             the card's (1e-4 on 99.9 %), ``batched_move_to`` with per-map
             positions equals per-map ``move_to`` bit for bit, and
             ``batched_input_image`` at B = 4 equals per-map ``input_image``
             in both occlusion modes. Then NCCL on the one card: a
             one-process group (``parallel.distributed.initialize`` on a free
             local port), a (1, 1) pod mesh, ``shard_states``, a batched
             step fed through ``HostFeed``, ``batch_stats`` through NCCL's
             all-reduce and a checkpoint round trip bit for bit; the group
             is torn down before the last line.
14. service - ``MappingService.from_settings`` with the deployed config and
             core_param.yaml's ROS-layer keys (literals: the card's machine
             has no PyYAML) on the card, the native frame ring enabled and
             one publisher of the deployed layers at 5 fps. First the native
             code at 131072 points: deinterleave, rgb packing and a ring
             push/pop equal to their plain versions bit for bit, and their
             host time. Then 2 warm-up and 12 timed frames: the pose update
             along the robot's arc, a producer thread pushing the frame's
             PointCloud2-style records (131072 points of the scene, x/y/z
             and one padding float, 16 bytes each, 1 % with a NaN
             coordinate) into the ring, and ``spin_once`` at the frame's
             time (10 Hz) on the main thread: 3 K1 launches per frame at
             checked shapes, K2 none; latency median and p90 (each spin
             ended by a synchronise), frames/s, peak memory, device ms and
             operations per frame (torch.profiler over 3 more frames). Then
             one 480x640 rgb image frame (no kernel launch), two submaps
             (map frame and a yawed request frame) and CheckSafety on one
             polygon. The CPU port's service takes the same frames, poses,
             image and queries: the final map within 1e-4 on 99.9 % of
             cells (colour bit for bit), the submaps likewise, the same
             safety answer, statistics and publishes. Then the semantic
             sensor path: ``PointcloudSensorNode(semantic_model="dino_vits8",
             device="cuda")`` (the full-width vit_small/8 at bf16) turns 3
             synthetic 480x640 depth+rgb frames into clouds with three DINO
             channels, which a service on semantic_mem.yaml's tables fuses
             (rgb -> color, the rest -> class_average): 5 K1 launches per
             frame, one per fusion present beside the 3 of the geometry, at
             checked shapes; the same clouds through the CPU port's service
             give the same map. ``DinoFeaturizer.predict`` at 480x640 is
             timed on its own.
15. dino    - vit_small/8 on one 224x224 image, card against the CPU port
             (the same seeded weights): at float32 tokens and code within
             1e-4 (TF32 must be off); at bf16 no farther from the CPU's
             bf16 result, in the maximum and in the mean, than the CPU's
             bf16 result is from its float32 one on the same image (the
             card and the CPU add the float32 products of bf16 operands in
             another order, and twelve blocks amplify each rounding
             flip). Then bench.py::bench_dino's shapes:
             ``dino_featurize`` with vit_small/16 on 16 images of 224x224 at
             bf16: batch ms, frames/s, device ms, the share of device time
             in matrix products, peak memory, and the FLOPs against the
             card's bf16 peak.

The line before the last is the card's name and power limit as nvidia-smi
gives them, the one before it the kernels line, and the last line is
``{"ok": true, "device": {...}}``. ``--json PATH`` also writes every
measured number of the run to PATH.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 rate outside the tensor cores (data sheet)
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
EXACT_UPDATES = 8
MAIN_CMP_UPDATES = 2
SEMANTIC_UPDATES = 8
ALL_FUSIONS_UPDATES = 3
PLUGIN_UPDATES = 2
PLUGIN_TIMED_CALLS = 10
# the polygon of the JAX package's profile.py: a right triangle of 2 m legs, moved
# so that its centroid is the map's centre
PROFILE_TRIANGLE = np.array([[0.0, 0.0], [2.0, 0.0], [0.0, 2.0]], np.float32)
# initialize_map's sparse points, (x, y, z) about the map's centre
INIT_POINTS = np.array([
    [1.5, 1.2, 0.1], [-1.8, 1.0, 0.25], [1.0, -2.2, -0.05], [-1.4, -1.6, 0.3],
    [0.1, 0.2, 0.15], [2.4, -0.4, 0.0], [-0.3, 2.6, 0.2], [-2.5, -0.2, 0.05],
])
IMAGE_SHAPE = (480, 640)
IMAGE_CALLS = {"shadow": 10, "bresenham": 2}
# image path, card against CPU: atan2/cos/sin round an ulp apart, which can
# move a cell across an azimuth bin, an image edge or a pixel boundary
IMAGE_MIN_SHARE = 0.995
# class_max keeps the 32 smallest distinct ids (semantic/fusions.py)
MAX_CLASSES = 32
EXACT_CMP_UPDATES = 2
MARCH_RAYS = (131072, 1 << 20)
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
# plane segmentation: bench.py::bench_planeseg's scene and counts
PLANESEG_N = 202
PLANESEG_CALLS = 10
PLANESEG_BATCH = 16
PLANESEG_BATCH_CALLS = 5
PLANESEG_BINS = 65  # PlaneSegParams().max_labels + 1
# card against CPU port: plane normals and supports, and the float layers on
# PLANESEG_MIN_SHARE of cells, within PLANESEG_TOL
PLANESEG_TOL = 1e-5
PLANESEG_MIN_SHARE = 0.999
PROFILE_POINTS = 100_000
PROFILE_ITERS = 10
PROFILE_ARGS = ["--iters", str(PROFILE_ITERS), "--points", str(PROFILE_POINTS)]
# the mapper pads a cloud to a power of two (mapper.py::_bucket)
PROFILE_BUCKET = max(1024, 1 << (PROFILE_POINTS - 1).bit_length())
# the batched phase: bench.py::bench_maps' 64 maps of 100000 points, 10 steps
BATCH_SIZES = (64, 1, 16)
BATCH_POINTS = 100_000
BATCH_STEPS = 10
# card batch against per-map updates on the card (tests/test_parallel.py's
# tolerance), on this share of cells
BATCH_TOL = 1e-5
BATCH_CPU_MAPS = 4
BATCH_IMAGE_MAPS = 4
BATCH_IMAGE_SHAPE = (240, 320)
SERVICE_FRAMES = 12
SERVICE_WARMUP = 2
SERVICE_PERIOD = 0.1        # s between frames (the deployed 10 Hz time_interval)
SERVICE_PUBLISH_FPS = 5.0
SERVICE_NAN_SHARE = 0.01
POINT_STEP = 16             # x, y, z and one padding float
SENSOR_FRAMES = 3
SENSOR_PREDICT_CALLS = 5
SENSOR_CHANNELS = ("grass", "tree", "person")
SENSOR_BUCKET = 1 << 19     # 480 x 640 depth pixels padded to a power of two
DINO_SIZE = 224
DINO_BATCH = 16
DINO_ITERS = 10
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
MEM_CHANNELS = ("rgb", "grass", "tree", "person")
ALL_FUSIONS_TABLE = (
    ("f_avg", "average"), ("f_bayes", "bayesian_inference"), ("f_dir", "class_bayesian"), ("max_.*", "class_max"),
)
ALL_FUSIONS_CHANNELS = ("f_avg", "f_bayes", "f_dir", "max_a", "max_b")
LAYERS = ["elevation", "variance", "is_valid", "traversability", "time",
          "upper_bound", "is_upper_bound", "normal_x", "normal_y", "normal_z"]
# configs/plugin_config.yaml as a literal (the card's machine has no PyYAML;
# tests/test_torch_plugins.py holds it to the YAML): per plugin its type,
# layer name, fill_nan, is_height_layer and extra_params
PLUGIN_SETTINGS = (
    ("min_filter", "min_filter", True, True, {"dilation_size": 1, "iteration_n": 2}),
    ("smooth_filter", "smooth", False, True, {"input_layer_name": "elevation"}),
    ("inpainting", "inpaint", False, True, {"method": "telea"}),
    ("max_filter", "max_filter", True, True, {"dilation_size": 1, "iteration_n": 2}),
    ("erosion", "erosion", False, False, {"input_layer_name": "traversability"}),
    ("semantic_traversability", "semantic_traversability", False, False,
     {"layers": ["traversability"], "thresholds": [0.3], "type": ["traversability"]}),
    ("max_layer_filter", "max_layer", False, False,
     {"layers": ["traversability"], "reverse": [True], "min_or_max": "max", "thresholds": [False], "scales": [1.0]}),
    ("robot_centric_elevation", "robot_centric_elevation", False, False,
     {"resolution": 0.1, "threshold": 0.0, "use_threshold": False}),
)
# the two plugins over semantic layers that the plugins phase adds, over
# semantic_mem.yaml's class layers
CLASS_LAYERS = ["grass", "tree", "person"]
SEMANTIC_PLUGIN_SETTINGS = (
    ("semantic_filter", "semantic_filter", False, False, {"classes": CLASS_LAYERS}),
    ("features_pca", "features_pca", False, False, {"process_layer_names": CLASS_LAYERS}),
)


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


# the ROS-layer keys of configs/core_param.yaml, which
# MappingService.from_settings wires as from_config does
# (tests/test_torch_runtime.py holds them to the YAML)
DEPLOYED_EXTRAS = {
    "map_frame": "odom", "base_frame": "base_footprint", "corrected_map_frame": "odom",
    "update_variance_fps": 5.0, "update_pose_fps": 10.0, "map_acquire_fps": 5.0, "publish_statistics_fps": 1.0,
    "position_lowpass_alpha": 0.2, "orientation_lowpass_alpha": 0.2, "initialize_method": "linear",
    "use_initializer_at_start": True,
}


def semantic_config():
    """The deployed config with ``configs/semantic_mem.yaml``'s semantic
    keys (tests/test_torch_core.py holds them to the YAML)."""
    return deployed_config().replace(
        semantic_layers=MEM_CHANNELS,
        pointcloud_channel_fusions=(("rgb", "color"), ("default", "class_average")),
        image_channel_fusions=(("rgb", "color"), ("default", "exponential")),
        average_weight=0.5,
        image_exponential_alpha=0.7,
    )


def plugin_settings(settings=PLUGIN_SETTINGS):
    """(plugin params, extra params) for ``PluginManager.init`` from a
    settings table such as PLUGIN_SETTINGS."""
    from elevation_mapping_cupy_torch.plugins import PluginParams

    params = [PluginParams(name=t, layer_name=l, fill_nan=f, is_height_layer=h) for t, l, f, h, _ in settings]
    return params, [copy.deepcopy(extra) for *_, extra in settings]


def pca_channels(got: np.ndarray, want: np.ndarray) -> list:
    """Two features_pca layers (0x00RRGGBB in a float32's bits) channel by
    channel: an eigenvector's sign is its solver's choice. A channel is
    c = trunc(x) with x the projection scaled to 0..255; a flipped axis
    gives trunc(255 - x), which is 254 - c (255 - c where x is a whole
    number), and the two solvers' roundings move either truncation by one.
    Returns per channel "equal" (|c' - c| <= 1 on every cell) or "mirrored"
    (|c' - (254 - c)| <= 1 on every cell); raises if a channel is neither."""
    a = np.ascontiguousarray(got, np.float32).view(np.uint32).astype(np.int64)
    b = np.ascontiguousarray(want, np.float32).view(np.uint32).astype(np.int64)
    if (a >> 24).any() or (b >> 24).any():
        raise AssertionError("features_pca: a value is no packed colour")
    out = []
    for shift in (16, 8, 0):
        ca, cb = (a >> shift) & 0xFF, (b >> shift) & 0xFF
        if np.abs(ca - cb).max(initial=0) <= 1:
            out.append("equal")
        elif np.abs(ca - (254 - cb)).max(initial=0) <= 1:
            out.append("mirrored")
        else:
            raise AssertionError(
                f"features_pca channel {2 - shift // 8}: off by {np.abs(ca - cb).max()} "
                f"(mirrored: {np.abs(ca - (254 - cb)).max()})"
            )
    return out


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


def pack_rgb(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) integers 0-255 -> float32 with the bits 0x00RRGGBB."""
    rgb = rgb.astype(np.uint32)
    return ((rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]).view(np.float32)


def pack_class(prob: np.ndarray, cls: np.ndarray) -> np.ndarray:
    """float32 with the class id in the high and float16(prob) in the low 16
    bits (past 65504 the half is infinity)."""
    with np.errstate(over="ignore"):
        half = prob.astype(np.float16).view(np.uint16)
    return ((cls.astype(np.uint32) << 16) | half).view(np.float32)


def mem_cloud(rng: np.random.Generator, n: int, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """The scene with a packed colour and three class scores in [0, 1] per point."""
    return np.concatenate(
        [scene_cloud(rng, n, R, t), pack_rgb(rng.integers(0, 256, (n, 3)))[:, None],
         rng.random((n, 3), dtype=np.float32)], axis=1,
    )


def all_fusions_cloud(rng: np.random.Generator, n: int, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """The scene with three feature columns (the third in [-1, 1]: class_bayesian
    drops the negatives) and two class_max columns of 8 ids."""
    feats = rng.random((n, 3), dtype=np.float32)
    feats[:, 2] = 2.0 * feats[:, 2] - 1.0
    packed = pack_class(rng.uniform(0.2, 1.0, (n, 2)).astype(np.float32), rng.integers(1, 9, (n, 2)))
    return np.concatenate([scene_cloud(rng, n, R, t), feats, packed], axis=1)


def planeseg_scene(rng: np.random.Generator, n: int = PLANESEG_N) -> np.ndarray:
    """bench.py::bench_planeseg's height map: flat ground, two raised boxes,
    2 mm of noise, 2 % NaN holes."""
    h = np.zeros((n, n), np.float32)
    h[60:120, 40:160] = 0.3
    h[140:190, 20:90] = 0.15
    h += rng.normal(0, 0.002, (n, n)).astype(np.float32)
    h[rng.random((n, n)) < 0.02] = np.nan
    return h


def planeseg_labels(h: np.ndarray) -> np.ndarray:
    """The plane labels of a height map by the CPU port (the card's are the
    same; the planeseg phase checks it)."""
    from elevation_mapping_cupy_torch.planeseg import extract as E

    return E.extract_planes(E.preprocess(torch.from_numpy(h)), 0.04, E.PlaneSegParams()).labels.numpy()


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

    Now and then the tracer returns no device record at all for a window
    (seen once in the march phase on one machine): later windows also
    trace the host, and after five empty windows the time comes from CUDA
    events around the same calls, named so in the returned operations."""
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


def check_scatter_case(rng, label: str, b: int, n: int, n_cells: int, exact, timed: bool = True,
                       int_max: int = 1, idx_np=None, n_real=None):
    """K1 against its plain version on the card at one shape; returns the
    measured numbers. Integer streams hold 0..int_max; ``idx_np`` gives the
    (b, n) indices where the default density does not fit the caller;
    points from ``n_real`` on are masked off, as the mapper's padding is."""
    from elevation_mapping_cupy_torch.ops import cuda_scatter as cs

    k = len(exact)
    dev = "cuda"
    idx = torch.from_numpy(_cell_indices(rng, b, n, n_cells) if idx_np is None else idx_np).to(dev)
    mask_np = rng.random((b, n)) > 0.15
    if n_real is not None:
        mask_np[:, n_real:] = False
    mask = torch.from_numpy(mask_np).to(dev)
    vals_np = rng.normal(0.5, 0.3, (b, k, n)).astype(np.float32)
    for s, e in enumerate(exact):
        if e:
            vals_np[:, s] = rng.integers(0, int_max + 1, (b, n))
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
    res = {"case": label, "B": b, "N": n, "K": k, "n_cells": n_cells, "max_abs_err": err, "max_rel_err": rel,
           "path": cs.launch_plan(b, k, n, n_cells).path}
    if not timed:
        log("kernel check: " + json.dumps(res))
        return res

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
    """K1 at every shape the main path gives it, plus the edge cases. Both
    of its paths are checked: the deployed map's scatters must take the
    shared-memory path and the cube's the global one."""
    rng = np.random.default_rng(0)
    cells = cfg.cell_n * cfg.cell_n
    bins = bins_main = cfg.azimuth_bins * (cfg.n_ray_steps + 2) * cfg.raycast_elevation_bins
    cases = {}
    for n in (MAIN_POINTS, 1 << 20):
        cases[("count", n)] = check_scatter_case(rng, f"error counting N={n}", 1, n, cells, (True, True))
        cases[("fusion", n)] = check_scatter_case(
            rng, f"point fusion N={n}", 1, n, cells, (False, False, True, True)
        )
        cases[("cube", n)] = check_scatter_case(rng, f"polar cube N={n}", 1, n, bins, (True, False))
    # the semantic fusions' launches (semantic/fusions.py): L feature streams
    # (_sum_features), the colour's count and r, g, b as integers 0-255 (one
    # launch of 4 in the port, of 1 and of 3 in the JAX package), and
    # class_max's (point, layer) pairs over (bucket, cell) bins
    n = MAIN_POINTS
    cases[("features3", n)] = check_scatter_case(rng, f"semantic features K=3 N={n}", 1, n, cells, (False,) * 3)
    cases[("features8", n)] = check_scatter_case(rng, f"semantic features K=8 N={n}", 1, n, cells, (False,) * 8)
    cases[("colour4", n)] = check_scatter_case(rng, f"colour count+rgb K=4 N={n}", 1, n, cells, (True,) * 4, int_max=255)
    cases[("colour3", n)] = check_scatter_case(rng, f"colour rgb K=3 N={n}", 1, n, cells, (True,) * 3, int_max=255)
    cases[("count1", n)] = check_scatter_case(rng, f"colour count K=1 N={n}", 1, n, cells, (True,))
    pairs = np.repeat(_cell_indices(rng, 1, n, cells), 2, axis=1)
    pairs = (pairs + cells * rng.integers(0, 9, pairs.shape)).astype(np.int32)  # 8 ids and the 0 of an empty map
    cases[("cube_class_max", n)] = check_scatter_case(
        rng, f"class_max K=1 N={2 * n} bins={MAX_CLASSES * cells}", 1, 2 * n, MAX_CLASSES * cells, (False,), idx_np=pairs
    )
    # plane decomposition's two launches (planeseg/extract.py) on the labels
    # of bench_planeseg's scene: N = 202 * 202 cells into max_labels + 1 = 65
    # bins, 70 % of them in one; one map, and the batch of 16 of update_batch
    n = PLANESEG_N * PLANESEG_N
    lab = planeseg_labels(planeseg_scene(np.random.default_rng(0))).reshape(1, n).astype(np.int32)
    bins = PLANESEG_BINS
    cases[("planeseg_moments", n)] = check_scatter_case(
        rng, f"planeseg moments K=10 N={n} bins={bins}", 1, n, bins, (False,) * 10, idx_np=lab
    )
    cases[("planeseg_label_bad", n)] = check_scatter_case(
        rng, f"planeseg label_bad K=1 N={n} bins={bins}", 1, n, bins, (True,), idx_np=lab
    )
    cases[("planeseg_batch_moments", n)] = check_scatter_case(
        rng, f"planeseg batch moments B={PLANESEG_BATCH} K=10 N={n} bins={bins}", PLANESEG_BATCH, n, bins,
        (False,) * 10, idx_np=np.repeat(lab, PLANESEG_BATCH, axis=0),
    )
    cases[("planeseg_batch_label_bad", n)] = check_scatter_case(
        rng, f"planeseg batch label_bad B={PLANESEG_BATCH} K=1 N={n} bins={bins}", PLANESEG_BATCH, n, bins,
        (True,), idx_np=np.repeat(lab, PLANESEG_BATCH, axis=0),
    )
    # the profile entry point's five launches per update (profile.py): the
    # default MapConfig's map and polar cube, PROFILE_POINTS points padded
    # to PROFILE_BUCKET, colour and class_bayesian over its four channels
    from elevation_mapping_cupy_torch import profile

    pcfg = profile.profile_config(PROFILE_POINTS)
    n, real = PROFILE_BUCKET, PROFILE_POINTS
    pcells = pcfg.cell_n * pcfg.cell_n
    pbins = pcfg.azimuth_bins * (pcfg.n_ray_steps + 2) * pcfg.raycast_elevation_bins
    cases[("profile_count", n)] = check_scatter_case(
        rng, f"profile error counting N={n} ({real} real)", 1, n, pcells, (True, True), n_real=real
    )
    cases[("profile_fusion", n)] = check_scatter_case(
        rng, f"profile point fusion N={n} ({real} real)", 1, n, pcells, (False, False, True, True), n_real=real
    )
    cases[("profile_cube", n)] = check_scatter_case(
        rng, f"profile polar cube N={n} ({real} real) bins={pbins}", 1, n, pbins, (True, False), n_real=real
    )
    cases[("profile_class_bayesian", n)] = check_scatter_case(
        rng, f"profile class_bayesian K=3 N={n} ({real} real)", 1, n, pcells, (False,) * 3, n_real=real
    )
    cases[("profile_colour4", n)] = check_scatter_case(
        rng, f"profile colour count+rgb K=4 N={n} ({real} real)", 1, n, pcells, (True,) * 4, int_max=255, n_real=real
    )
    # the batched phase's three launches per step (parallel.batched_update
    # at the default MapConfig, BATCH_POINTS unpadded points a map) at each
    # of its batch sizes: the whole batch in one launch
    n = BATCH_POINTS
    for b in BATCH_SIZES:
        cases[(f"batch{b}_count", n)] = check_scatter_case(
            rng, f"batched B={b} error counting N={n}", b, n, pcells, (True, True))
        cases[(f"batch{b}_fusion", n)] = check_scatter_case(
            rng, f"batched B={b} point fusion N={n}", b, n, pcells, (False, False, True, True))
        cases[(f"batch{b}_cube", n)] = check_scatter_case(
            rng, f"batched B={b} polar cube N={n} bins={pbins}", b, n, pbins, (True, False))
    # the semantic sensor path's five launches per frame: a 480x640 depth
    # frame's points (1 % without a return) padded to SENSOR_BUCKET, on the
    # deployed map (geometry 3; colour K=4 has the fusion's shape;
    # class_average over the three DINO channels K=3)
    n, real = SENSOR_BUCKET, int(0.99 * IMAGE_SHAPE[0] * IMAGE_SHAPE[1])
    cases[("sensor_count", n)] = check_scatter_case(
        rng, f"sensor error counting N={n} ({real} real)", 1, n, cells, (True, True), n_real=real)
    cases[("sensor_fusion", n)] = check_scatter_case(
        rng, f"sensor point fusion N={n} ({real} real)", 1, n, cells, (False, False, True, True), n_real=real)
    cases[("sensor_cube", n)] = check_scatter_case(
        rng, f"sensor polar cube N={n} ({real} real) bins={bins_main}", 1, n, bins_main, (True, False), n_real=real)
    cases[("sensor_features3", n)] = check_scatter_case(
        rng, f"sensor class_average K=3 N={n} ({real} real)", 1, n, cells, (False,) * 3, n_real=real)
    for (kind, n), res in cases.items():
        want = "global" if "cube" in kind else "private"
        if res["path"] != want:
            raise AssertionError(f"K1 {kind} N={n} took the {res['path']} path, expected {want}")
    check_scatter_case(rng, "zero points", 1, 0, cells, (True, True), timed=False)
    check_scatter_case(rng, "batched B=4", 4, MAIN_POINTS, cells, (False, False, True, True), timed=False)
    # the largest map of the shared-memory path and the first past it
    check_scatter_case(rng, "58112 cells", 1, MAIN_POINTS, 58112, (False, True), timed=False)
    check_scatter_case(rng, "58113 cells", 1, MAIN_POINTS, 58113, (False, True), timed=False)
    return cases


def _compare_layers(tag: str, got: dict, want: dict, packed=(), min_share: float = CMP_MIN_SHARE, where=None,
                    sums=()) -> dict:
    """Share of cells on which the card's layers agree with the CPU run's:
    within CMP_ATOL, or bit for bit for the names in ``packed`` (colour
    layers and class ids, integers in a float's bits). The names in ``sums``
    are per-cell sums of up to thousands of values, added in another order
    on the card: they are held to CMP_ATOL relative to max(1, |sum|), as
    K1's value streams are. ``where`` limits the comparison to a mask of
    cells."""
    stats = {}
    for name in want:
        a, b = got[name], want[name]
        if where is not None:
            a, b = a[where], b[where]
        if name in packed:
            close = np.ascontiguousarray(a).view(np.uint32) == np.ascontiguousarray(b).view(np.uint32)
            stats[name] = {"share_equal_bits": float(close.mean())}
        else:
            both_nan = np.isnan(a) & np.isnan(b)
            scale = np.maximum(1.0, np.abs(np.nan_to_num(b))) if name in sums else 1.0
            close = both_nan | (np.abs(np.nan_to_num(a, nan=1e9) - np.nan_to_num(b, nan=1e9)) <= CMP_ATOL * scale)
            finite = np.isfinite(a) & np.isfinite(b)
            stats[name] = {
                "share_within": float(close.mean()),
                "max_abs": float(np.abs(a[finite] - b[finite]).max()) if finite.any() else 0.0,
            }
        share = float(close.mean())
        if not share >= min_share:
            raise AssertionError(
                f"{tag}: layer {name}: {share:.5f} of cells "
                f"{'equal in bits to' if name in packed else f'within {CMP_ATOL} of'} the CPU run (need {min_share})"
            )
    return stats


def phase_main(cfg, kernel_regs):
    from elevation_mapping_cupy_torch.mapper import ElevationMap
    from elevation_mapping_cupy_torch.ops import raycast
    from elevation_mapping_cupy_torch.state import state_from_numpy, state_to_numpy

    if raycast.resolve_raycast_mode(cfg) != "polar":
        raise AssertionError("the deployed config must resolve to the polar cleanup")
    layers = LAYERS
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
        last = k >= 2 + N_UPDATES - MAIN_CMP_UPDATES
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
    check_launches("main path (polar)", launches, N_UPDATES, {"scatter_add_streams": 3, "exact_march": 0})
    mapped_state = em.state
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
    res["rates"] = rates
    prof = profile_updates(em, rng)
    # the profiler slows the host, so the busy share is taken against the
    # unprofiled latency of the main path
    prof["device_busy_share_of_median_latency"] = prof["device_ms_per_update"] / res["latency_ms_median"]
    log("profile: " + json.dumps(prof))
    return res, launches, mapped_state


@contextlib.contextmanager
def k1_shapes():
    """Records the (B, K, N, n_cells) of every K1 call made inside; the
    kernel's own wrapper still counts the launches."""
    from elevation_mapping_cupy_torch.ops import cuda_scatter as cs

    shapes, launch = set(), cs.scatter_add_streams

    def recording(idx, mask, values, n_cells):
        shapes.add(tuple(values.shape) + (n_cells,))
        return launch(idx, mask, values, n_cells)

    cs.scatter_add_streams = recording
    try:
        yield shapes
    finally:
        cs.scatter_add_streams = launch


def check_shapes(tag: str, shapes: set, checked: set) -> None:
    """K1 ran on this path, and only at shapes the kernels phase held
    against its plain version."""
    if not shapes or not shapes <= checked:
        raise AssertionError(f"{tag}: K1 shapes {sorted(shapes - checked)} not checked by the kernels phase "
                             f"(or no launch: {sorted(shapes)})")


def checked_shapes(cases: dict) -> set:
    return {(c["B"], c["K"], c["N"], c["n_cells"]) for c in cases.values()}


def check_launches(tag: str, launches: dict, updates: int, per_update: dict) -> None:
    """Every registered kernel's launches in one path's run against the
    count each update must make (0 for a kernel the path must not run)."""
    if set(launches) != set(per_update):
        raise AssertionError(f"{tag}: kernels {sorted(launches)}, expected {sorted(per_update)}")
    for name, each in per_update.items():
        if launches[name] != each * updates:
            raise AssertionError(
                f"{tag}: kernel {name} launched {launches[name]} times in {updates} updates, want {each} each"
            )


# ---------------------------------------------------------------------------
# K2: the exact march
# ---------------------------------------------------------------------------

def march_inputs(state, cfg, n_rays: int, rng, gated: bool, pose: int = N_UPDATES + 1):
    """K2's inputs as the exact cleanup builds them: the cell pack of
    ``state``, the end points and validity of ``n_rays`` rays of the scene
    seen from robot pose ``pose``, the sensor position, and the gate table
    when ``gated``."""
    from elevation_mapping_cupy_torch.ops import geometry, raycast

    dev = state.layers.device
    R, t, _ = robot_pose(pose)
    pts = torch.from_numpy(scene_cloud(rng, n_rays, R, t)).to(dev)
    t_c = torch.from_numpy(t).to(dev) - state.center
    assoc = geometry.associate_points(
        pts, torch.ones(n_rays, dtype=torch.bool, device=dev), torch.from_numpy(R).to(dev), t_c, cfg
    )
    pack = raycast.exact_precompute(state.layers, state.normal, torch.zeros_like(state.layers[0]), cfg)
    gate = raycast.exact_gate(pack, cfg) if gated else None
    return pack, assoc.world, assoc.valid, t_c, gate


def check_march_case(state, cfg, rng, n_rays: int, gated: bool, aged: bool = True) -> dict:
    """K2 against its plain version on the card at one shape; returns the
    measured numbers. On a map that is not ``aged`` past the recency gate no
    cell can be hit, and the march only lowers upper bounds."""
    from elevation_mapping_cupy_torch.ops import cuda_march as cm

    label = f"exact march N={n_rays} {'gated' if gated else 'ungated'}{'' if aged else ' fresh map'}"
    args = march_inputs(state, cfg, n_rays, rng, gated)
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
    if not bool(torch.isfinite(got.dec).all()) or rel > VALUE_TOL:
        raise AssertionError(f"{label}: decrement off by {rel} (relative) > {VALUE_TOL}")
    n2, n = cfg.cell_n**2, n_rays
    nb2 = args[4].table.numel() if gated else 0
    # the pack's 7 values per cell, the points, their validity, t, the gate
    # table, the three outputs and the two counts
    bytes_moved = 4 * (7 * n2 + 3 * n + 3 + nb2 + 3 * n2) + n + (16 if gated else 0)
    ops = sum(MARCH_OPS[key] * c for key, c in work.items())
    bytes_ms, ops_ms = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    res = {
        "case": label, "rays": n, "gated": gated, "aged": aged, "work": work,
        "counts": got.counts.tolist() if gated else None,
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
    res["share_of_bound"] = res["bound_ms"] / res["device_ms"]
    if (aged and res["hits"] == 0) or res["ub_cells"] == 0:
        raise AssertionError(f"{label}: the case must both hit cells and write upper bounds: {res}")
    log("kernel check: " + json.dumps(res))
    return res


def phase_march(cfg, mapped_state):
    """K2 at the deployed shapes, on the main phase's map aged past the
    recency gate (time >= 0.5) so that cells can be hit."""
    from elevation_mapping_cupy_torch import core
    from elevation_mapping_cupy_torch.ops import cuda_march as cm

    ecfg = cfg.replace(raycast_mode="exact")
    state = mapped_state
    for _ in range(7):
        state = core.update_time(state, ecfg)
    rng = np.random.default_rng(4)
    cases = {(n, g): check_march_case(state, ecfg, rng, n, g) for n in MARCH_RAYS for g in (True, False)}
    fresh = {
        (n, g): check_march_case(mapped_state, ecfg, rng, n, g, aged=False) for n in MARCH_RAYS for g in (True, False)
    }
    for name, group in (("aged", cases), ("fresh", fresh)):
        log(f"gated against flat, {name} map: " + json.dumps({
            str(n): {"gated_device_ms": group[(n, True)]["device_ms"], "flat_device_ms": group[(n, False)]["device_ms"],
                     "survivor_frac": group[(n, True)]["counts"][0] / max(group[(n, True)]["counts"][1], 1)}
            for n in MARCH_RAYS
        }))
    # edge cases: no rays (no launch), every ray masked (a launch, no writes)
    pack, world, valid, t, gate = march_inputs(state, ecfg, 4096, rng, True)
    before = cm.KERNEL.launches
    empty = cm.exact_march(pack, world[:0], valid[:0], t, ecfg, gate)
    masked = cm.exact_march(pack, world, torch.zeros_like(valid), t, ecfg, gate)
    torch.cuda.synchronize()
    if cm.KERNEL.launches != before + 1:
        raise AssertionError("K2: an empty march must not launch, a masked one must")
    for tag, r in (("empty", empty), ("masked", masked)):
        if r.counts.tolist() != [0, 0] or float(r.hits.sum()) != 0 or not bool(torch.isinf(r.ubmin).all()):
            raise AssertionError(f"K2 {tag} march wrote something")
    log("kernel check: exact march empty and all-masked: nothing written")
    return cases, fresh


def phase_exact(cfg, kernel_regs):
    """The exact cleanup through ``ElevationMap.input_pointcloud`` with the
    gated/flat router, compared with the CPU port on its last updates."""
    from elevation_mapping_cupy_torch.mapper import ElevationMap
    from elevation_mapping_cupy_torch.ops import raycast
    from elevation_mapping_cupy_torch.state import state_from_numpy, state_to_numpy

    ecfg = cfg.replace(raycast_mode="exact")
    if raycast.resolve_exact_impl(ecfg) != "gated":
        raise AssertionError("the deployed config's exact march must resolve to the routed gated march")
    em = ElevationMap(ecfg, device="cuda")
    cpu = ElevationMap(ecfg, device="cpu")
    t0 = time.perf_counter()
    warmed = em.warm_raycast_impls()
    warm_s = time.perf_counter() - t0
    if warmed != ["gated", "flat"]:
        raise AssertionError(f"warm_raycast_impls ran {warmed}")
    routes = []
    rng = np.random.default_rng(5)

    def step(k: int, n: int, compare: bool = False):
        R, t, pos = robot_pose(k)
        pts = scene_cloud(rng, n, R, t)
        em.move_to(pos, R)
        # the router decides from its own state alone: a copy tells which
        # march this update takes, and hands the CPU rerun the same choice
        routes.append(copy.deepcopy(em._exact_router).route())
        if compare:
            before, router = state_to_numpy(em.state), copy.deepcopy(em._exact_router)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        em.input_pointcloud(pts, ["x", "y", "z"], R, t, 0.0, 0.0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        stats = None
        if compare:
            cpu.state = state_from_numpy(before, "cpu")
            cpu._exact_router = router
            cpu.input_pointcloud(pts, ["x", "y", "z"], R, t, 0.0, 0.0)
            stats = _compare_layers(f"exact update {k}", em.get_layers(LAYERS), cpu.get_layers(LAYERS))
        em.update_time()  # age the map so that later rays can clean cells up
        return dt, stats

    for kern in kernel_regs.values():
        kern.launches = 0
    lat, cmp_stats = [], []
    for k in range(EXACT_UPDATES):
        dt, stats = step(k, MAIN_POINTS, compare=k >= EXACT_UPDATES - EXACT_CMP_UPDATES)
        lat.append(dt)
        if stats:
            cmp_stats.append(stats)
    launches = {name: kern.launches for name, kern in kernel_regs.items()}
    check_launches("exact path", launches, EXACT_UPDATES, {"scatter_add_streams": 2, "exact_march": 1})
    main_routes = list(routes)
    lat_1m = [step(EXACT_UPDATES + k, 1_000_000)[0] for k in range(6)]
    prof = profile_updates(em, rng, pose=EXACT_UPDATES + 5)
    out = em.get_layers(LAYERS)
    valid = out["is_valid"] > 0.5
    if valid.mean() < 0.2 or not np.isfinite(out["elevation"][valid]).all():
        raise AssertionError(f"implausible exact map: {valid.mean():.3f} of cells valid")
    ms = np.array(lat) * 1e3
    ms_1m = np.array(lat_1m[1:]) * 1e3
    prof["device_busy_share_of_median_latency"] = prof["device_ms_per_update"] / float(np.median(ms))
    log("exact profile: " + json.dumps(prof))
    res = {
        "updates": EXACT_UPDATES, "points": MAIN_POINTS, "warm_s": warm_s,
        "latency_ms_median": float(np.median(ms)), "latency_ms_p90": float(np.percentile(ms, 90)),
        "latency_ms": ms.tolist(), "routes": main_routes,
        "latency_1m_ms_median": float(np.median(ms_1m)), "latency_1m_ms_p90": float(np.percentile(ms_1m, 90)),
        "routes_1m": routes[len(main_routes):],
        "last_gate_survivor_frac": float(em._exact_router._last_frac),
        "launches": launches, "valid_share": float(valid.mean()), "cpu_compare": cmp_stats,
    }
    log("exact path: " + json.dumps(res))
    return res, launches


def phase_replay(cfg, kernel_regs):
    """A 3-frame log through ``runtime.replay.replay`` on the card and on
    the CPU (exact march)."""
    from elevation_mapping_cupy_torch.runtime.replay import LogWriter, replay

    rng = np.random.default_rng(6)
    w = LogWriter(["x", "y", "z"])
    for k in range(3):
        R, t, pos = robot_pose(2 * k)
        w.add(scene_cloud(rng, 20000, R, t), R, t, position=pos, stamp=0.1 * k)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "log.npz")
        w.save(path)
        for kern in kernel_regs.values():
            kern.launches = 0
        got = replay(path, cfg, snapshot_layers=LAYERS, raycast_mode="exact", device="cuda")
        torch.cuda.synchronize()
        launches = {name: kern.launches for name, kern in kernel_regs.items()}
        want = replay(path, cfg, snapshot_layers=LAYERS, raycast_mode="exact", device="cpu")
    check_launches("replay", launches, 3, {"scatter_add_streams": 2, "exact_march": 1})
    stats = [_compare_layers(f"replay frame {i}", g, c) for i, (g, c) in enumerate(zip(got, want))]
    log("replay: " + json.dumps({"frames": len(got), "launches": launches, "cpu_compare": stats}))


# ---------------------------------------------------------------------------
# semantic layers and the image path
# ---------------------------------------------------------------------------

def _semantic_names(cfg):
    return LAYERS + list(cfg.semantic_layers)


def _state_layers(state, cfg) -> dict:
    """sem_new and id_max rows by layer name, as host arrays (id_max as the
    float32 with its bits, so that ``_compare_layers`` can hold it bit for bit)."""
    sem_new = state.sem_new.cpu().numpy()
    ids = state.id_max.cpu().numpy().astype(np.uint32)
    out = {}
    for i, name in enumerate(cfg.semantic_layers):
        out[f"sem_new:{name}"] = sem_new[i]
        out[f"id_max:{name}"] = ids[i].view(np.float32)
    return out


def drive_semantic(tag, cfg, kernel_regs, make_cloud, channels, n_updates, k1_per_update, packed, seed):
    """``n_updates`` semantic updates of MAIN_POINTS points through
    ``ElevationMap.input_pointcloud`` on the card while the robot moves, the
    last rerun on the CPU port from the same state and compared."""
    from elevation_mapping_cupy_torch.mapper import ElevationMap
    from elevation_mapping_cupy_torch.state import state_from_numpy, state_to_numpy

    names = ["x", "y", "z"] + list(channels)
    rng = np.random.default_rng(seed)
    em = ElevationMap(cfg, device="cuda")
    cpu = ElevationMap(cfg, device="cpu")

    def update(k: int):
        R, t, pos = robot_pose(k)
        em.move_to(pos, R)
        return make_cloud(rng, MAIN_POINTS, R, t), R, t

    for k in range(2):  # warm-up, not counted
        pts, R, t = update(k)
        em.input_pointcloud(pts, names, R, t, 0.0, 0.0)
    torch.cuda.synchronize()
    for kern in kernel_regs.values():
        kern.launches = 0
    lat, cmp_stats = [], None
    for k in range(2, 2 + n_updates):
        pts, R, t = update(k)
        last = k == 1 + n_updates
        if last:
            before = state_to_numpy(em.state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        em.input_pointcloud(pts, names, R, t, 0.0, 0.0)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        if last:
            cpu.state = state_from_numpy(before, "cpu")
            cpu.input_pointcloud(pts, names, R, t, 0.0, 0.0)
            all_names = _semantic_names(cfg)
            cmp_stats = _compare_layers(f"{tag} update {k}", em.get_layers(all_names), cpu.get_layers(all_names), packed)
            ids = [f"id_max:{n}" for n in cfg.semantic_layers]
            cmp_stats.update(_compare_layers(
                f"{tag} update {k}", _state_layers(em.state, cfg), _state_layers(cpu.state, cfg), packed=ids,
                sums=[f"sem_new:{n}" for n in cfg.semantic_layers],
            ))
    launches = {name: kern.launches for name, kern in kernel_regs.items()}
    check_launches(tag, launches, n_updates, {"scatter_add_streams": k1_per_update, "exact_march": 0})
    prof = profile_updates(em, rng, n_updates=3, pose=1 + n_updates, make_cloud=make_cloud, channels=names)
    ms = np.array(lat) * 1e3
    med = float(np.median(ms))
    prof["device_busy_share_of_median_latency"] = prof["device_ms_per_update"] / med
    res = {
        "updates": n_updates, "points": MAIN_POINTS, "columns": len(names), "channels": list(channels),
        "latency_ms_median": med, "latency_ms_p90": float(np.percentile(ms, 90)), "latency_ms": ms.tolist(),
        "points_per_s": MAIN_POINTS / (med / 1e3), "launches": launches, "k1_launches_per_update": k1_per_update,
        "cpu_compare": cmp_stats, "profile": prof,
    }
    log(f"{tag}: " + json.dumps(res))
    return em, res


def check_packed_on_card(em) -> dict:
    """The bit-packed layers on the card: the packing helpers, a state round
    trip through NumPy, a whole-cell shift and the export, each against the
    CPU, bit for bit. Nothing may compute on or flush a packed value."""
    from elevation_mapping_cupy_torch import core
    from elevation_mapping_cupy_torch.mapper import ElevationMap
    from elevation_mapping_cupy_torch.semantic import fusions as F
    from elevation_mapping_cupy_torch.state import state_from_numpy, state_to_numpy

    def bits(x):
        return np.ascontiguousarray(x.detach().cpu().numpy()).view(np.uint32)

    def same_floats(c, g):
        # a NaN half decodes to a NaN on both; the card's conversion does not keep its payload
        c, g = c.cpu().numpy(), g.cpu().numpy()
        nan = np.isnan(c)
        return np.array_equal(nan, np.isnan(g)) and np.array_equal(c[~nan].view(np.uint32), g[~nan].view(np.uint32))

    rng = np.random.default_rng(8)
    half = np.arange(1 << 16, dtype=np.uint32)
    mer = torch.from_numpy(((rng.integers(0, 1 << 16, 1 << 16).astype(np.uint32) << 16) | half).view(np.float32))
    prob = torch.from_numpy(np.concatenate([rng.uniform(-70000, 70000, 50000), 10.0 ** rng.uniform(-9, 5, 50000)]).astype(np.float32))
    cls = torch.from_numpy(rng.integers(0, 1 << 16, prob.shape[0]))
    colour = torch.from_numpy(pack_rgb(rng.integers(0, 256, (100000, 3))))
    for name, fn, args in (
        ("decode_max", F.decode_max, (mer,)), ("encode_max", F.encode_max, (prob, cls)),
        ("rgb_float_to_uint", F.rgb_float_to_uint, (colour,)),
        ("uint_to_rgb_float", lambda c: F.uint_to_rgb_float(*F.rgb_float_to_uint(c)), (colour,)),
    ):
        on_cpu, on_card = fn(*args), fn(*(a.cuda() for a in args))
        pairs = zip(on_cpu, on_card) if isinstance(on_cpu, tuple) else [(on_cpu, on_card)]
        for c, g in pairs:
            same = torch.equal(c, g.cpu()) if c.dtype == torch.int64 else same_floats(c, g)
            if not same:
                raise AssertionError(f"packed layers: {name} differs between the card and the CPU")

    cfg, state = em.cfg, em.state
    rgb = cfg.semantic_layers.index("rgb")
    arrays = state_to_numpy(state)
    n_colour = int(np.count_nonzero(arrays["semantic"][rgb]))
    if n_colour < 1000 or not (np.abs(arrays["semantic"][rgb]) < 2.4e-38).all():
        raise AssertionError(f"packed layers: the colour layer holds {n_colour} coloured cells or a value that is no packed colour")
    again = state_from_numpy(arrays, "cuda")
    if not np.array_equal(bits(again.semantic), bits(state.semantic)) or not torch.equal(again.id_max, state.id_max):
        raise AssertionError("packed layers: a state round trip through NumPy changed bits")
    cpu_state = state_from_numpy(arrays, "cpu")
    moved, moved_cpu = core.shift_map_xy(state, 5, -3, cfg), core.shift_map_xy(cpu_state, 5, -3, cfg)
    for field in ("semantic", "sem_new", "id_max"):
        a, b = getattr(moved, field).cpu(), getattr(moved_cpu, field)
        if not np.array_equal(a.numpy().view(np.uint32 if a.dtype == torch.float32 else np.int64),
                              b.numpy().view(np.uint32 if b.dtype == torch.float32 else np.int64)):
            raise AssertionError(f"packed layers: shift_map_xy moved {field} differently on the card")
    cpu = ElevationMap(cfg, device="cpu")
    cpu.state = cpu_state
    if not np.array_equal(em.get_layers(["rgb"])["rgb"].view(np.uint32), cpu.get_layers(["rgb"])["rgb"].view(np.uint32)):
        raise AssertionError("packed layers: the colour export differs between the card and the CPU")
    res = {"coloured_cells": n_colour, "helpers": "equal", "state_round_trip": "equal", "shift": "equal", "export": "equal"}
    log("packed layers on the card: " + json.dumps(res))
    return res


def phase_semantic(cfg, kernel_regs):
    """Both semantic maps (module docstring, phase 8). Returns the first
    map, the results and the launches of each."""
    from elevation_mapping_cupy_torch.ops import cuda_scatter as cs

    mem_cfg = semantic_config()
    em, mem = drive_semantic(
        "semantic (rgb + 3 class_average)", mem_cfg, kernel_regs, mem_cloud, MEM_CHANNELS, SEMANTIC_UPDATES,
        k1_per_update=5, packed=("rgb",), seed=7,
    )
    mem["packed_on_card"] = check_packed_on_card(em)
    all_cfg = cfg.replace(semantic_layers=ALL_FUSIONS_CHANNELS, pointcloud_channel_fusions=ALL_FUSIONS_TABLE)
    bins = MAX_CLASSES * cfg.cell_n**2
    if cs.launch_plan(1, 1, 2 * MAIN_POINTS, bins).path != "global":
        raise AssertionError(f"class_max's {bins} bins must take K1's global path")
    em_all, allf = drive_semantic(
        "semantic (all six fusions)", all_cfg, kernel_regs, all_fusions_cloud, ALL_FUSIONS_CHANNELS,
        ALL_FUSIONS_UPDATES, k1_per_update=7, packed=(), seed=9,
    )
    ids = em_all.state.id_max[3:].unique().tolist()
    if not set(ids) <= set(range(9)) or len(ids) < 8:
        raise AssertionError(f"class_max wrote the ids {ids}, the clouds hold 1..8")
    sem = em_all.get_layers(list(ALL_FUSIONS_CHANNELS))
    for name in ("f_avg", "f_dir", "max_a", "max_b"):  # f_bayes stays 0: the reference's frozen posterior
        if not np.isfinite(sem[name]).all() or np.count_nonzero(sem[name]) < 0.12 * cfg.cell_n**2:
            raise AssertionError(f"semantic layer {name} has {np.count_nonzero(sem[name])} non-zero cells")
    return em, mem, allf


def phase_image(em, kernel_regs):
    """``input_image`` on the mapped semantic state in both occlusion modes
    (module docstring, phase 9), each against the CPU port."""
    from elevation_mapping_cupy_torch import core
    from elevation_mapping_cupy_torch.mapper import ElevationMap
    from elevation_mapping_cupy_torch.state import state_from_numpy, state_to_numpy

    rng = np.random.default_rng(10)
    H, W = IMAGE_SHAPE
    img = np.concatenate([rng.integers(0, 256, (3, H, W)), rng.random((1, H, W))]).astype(np.float32)
    K = np.array([[400.0, 0, W / 2], [0, 400.0, H / 2], [0, 0, 1]], np.float32)
    R = np.array([[1.0, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    # the camera looks down from 1.5 m above a point 0.6 m ahead of the map's
    # centre, a box at the edge of its view: t = -R c
    t = -R @ (em.center + np.array([0.6, -0.2, 1.5], np.float32))
    D = np.zeros(5, np.float32)
    channels = ["rgb", "mask"]
    start = state_to_numpy(em.state)
    out = {}
    for mode, calls in IMAGE_CALLS.items():
        cfg = em.cfg.replace(image_occlusion_mode=mode)
        gpu, cpu = ElevationMap(cfg, device="cuda"), ElevationMap(cfg, device="cpu")
        gpu.state, cpu.state = state_from_numpy(start, "cuda"), state_from_numpy(start, "cpu")
        gpu.input_image(img, channels, R, t, K, D)  # warm-up; grows the mask layer
        gpu.state = state_from_numpy(start, "cuda")
        gpu.cfg = cfg
        torch.cuda.synchronize()
        for kern in kernel_regs.values():
            kern.launches = 0
        lat = []
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gpu.input_image(img, channels, R, t, K, D)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        launches = {name: kern.launches for name, kern in kernel_regs.items()}
        check_launches(f"image ({mode})", launches, calls, {"scatter_add_streams": 0, "exact_march": 0})
        t0 = time.perf_counter()
        for _ in range(calls):
            cpu.input_image(img, channels, R, t, K, D)
        cpu_ms = (time.perf_counter() - t0) / calls * 1e3
        dev = lambda em_, x: torch.as_tensor(x, device=em_.device)  # noqa: E731
        valid = {}
        for tag, m in (("card", gpu), ("cpu", cpu)):
            before = state_from_numpy(start, m.device)
            valid[tag] = core.image_correspondence(
                before, H, W, dev(m, R), dev(m, t), dev(m, K), dev(m, D), cfg
            )[1].cpu().numpy()
        agree = float((valid["card"] == valid["cpu"]).mean())
        n_valid = int(valid["cpu"].sum())
        if agree < IMAGE_MIN_SHARE or n_valid < 0.02 * cfg.cell_n**2:
            raise AssertionError(f"image ({mode}): valid agrees on {agree:.5f} of cells, {n_valid} valid on the CPU")
        both = (valid["card"] & valid["cpu"])[1:-1, 1:-1][::-1, ::-1]
        stats = _compare_layers(
            f"image ({mode})", gpu.get_layers(channels), cpu.get_layers(channels), packed=("rgb",),
            min_share=IMAGE_MIN_SHARE, where=both,
        )
        prof = profile_calls([lambda: gpu.input_image(img, channels, R, t, K, D)] * min(calls, 3))
        ms = np.array(lat) * 1e3
        prof["device_busy_share_of_median_latency"] = prof["device_ms_per_update"] / float(np.median(ms))
        out[mode] = {
            "calls": calls, "image": [4, H, W], "latency_ms_median": float(np.median(ms)),
            "latency_ms_p90": float(np.percentile(ms, 90)), "latency_ms": ms.tolist(), "cpu_port_ms": cpu_ms,
            "valid_cells": n_valid, "valid_agreement": agree, "cpu_compare": stats, "launches": launches,
            "profile": prof,
        }
        log(f"image ({mode}): " + json.dumps(out[mode]))
    return out


# ---------------------------------------------------------------------------
# post-processing: plugins, polygon query, initialize_map
# ---------------------------------------------------------------------------

def _latency_ms(fn, calls: int = PLUGIN_TIMED_CALLS) -> dict:
    """Host clock around ``calls`` calls of ``fn``, each ended by a
    synchronise: median and p90 in ms (after one untimed call)."""
    fn()
    lat = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return {"latency_ms_median": float(np.median(lat)), "latency_ms_p90": float(np.percentile(lat, 90))}


def _timed_call(fn) -> dict:
    """Latency and, from torch.profiler, device ms and device operations per
    call of ``fn``."""
    res = _latency_ms(fn)
    prof = profile_calls([fn] * 3)
    res["device_ms"] = prof["device_ms_per_update"]
    res["device_ops"] = prof["device_ops_per_update"]
    res["top_device_ms"] = dict(list(prof["top_device_ms_per_update"].items())[:4])
    return res


def _compare_plugin_layers(tag: str, got: dict, want: dict) -> dict:
    """Card against CPU plugin layers: semantic_filter bit for bit on every
    cell, features_pca channel by channel, the float layers within CMP_ATOL
    on CMP_MIN_SHARE of cells with NaN exactly where the CPU has NaN."""
    stats = {}
    floats = [nm for nm in want if nm not in ("semantic_filter", "features_pca")]
    for nm in floats:
        if not np.array_equal(np.isnan(got[nm]), np.isnan(want[nm])):
            raise AssertionError(f"{tag}: {nm} has NaN in other cells than on the CPU")
    stats.update(_compare_layers(tag, {nm: got[nm] for nm in floats}, {nm: want[nm] for nm in floats}))
    if "semantic_filter" in want:
        stats.update(_compare_layers(tag, {"semantic_filter": got["semantic_filter"]},
                                     {"semantic_filter": want["semantic_filter"]},
                                     packed=("semantic_filter",), min_share=1.0))
    if "features_pca" in want:
        stats["features_pca"] = {"channels": pca_channels(got["features_pca"], want["features_pca"])}
    return stats


def phase_plugins(em, kernel_regs):
    """Post-processing on the first semantic map (module docstring, phase
    10), against the CPU port."""
    from elevation_mapping_cupy_torch.mapper import ElevationMap
    from elevation_mapping_cupy_torch.ops import stencil
    from elevation_mapping_cupy_torch.plugins.builtin import cv2_available
    from elevation_mapping_cupy_torch.state import state_from_numpy, state_to_numpy

    cv2 = cv2_available()
    log("plugins: cv2 " + ("installed: inpainting and erosion take their cv2 branch on the host" if cv2 else
                           "not installed: inpainting diffuses on the card, erosion takes a NumPy minimum"))
    settings = PLUGIN_SETTINGS + SEMANTIC_PLUGIN_SETTINGS
    em.plugin_manager.init(*plugin_settings(settings))
    names = em.plugin_manager.layer_names
    channels = ["x", "y", "z"] + list(MEM_CHANNELS)
    rng = np.random.default_rng(11)
    for kern in kernel_regs.values():
        kern.launches = 0
    for k in range(PLUGIN_UPDATES):
        R, t, pos = robot_pose(2 + SEMANTIC_UPDATES + k)
        em.move_to(pos, R)
        em.input_pointcloud(mem_cloud(rng, MAIN_POINTS, R, t), channels, R, t, 0.0, 0.0)
    torch.cuda.synchronize()
    update_launches = {name: kern.launches for name, kern in kernel_regs.items()}
    check_launches("plugins (updates)", update_launches, PLUGIN_UPDATES, {"scatter_add_streams": 5, "exact_march": 0})

    cpu = ElevationMap(em.cfg, device="cpu")
    cpu.state = state_from_numpy(state_to_numpy(em.state), "cpu")
    cpu.plugin_manager.init(*plugin_settings(settings))
    cpu.plugin_manager.layers = em.plugin_manager.layers.cpu()
    n = em.cell_n
    for kern in kernel_regs.values():
        kern.launches = 0
    got, want = {}, {}
    for nm in names:
        got[nm], want[nm] = np.full((n - 2, n - 2), 7.0, np.float32), np.full((n - 2, n - 2), 7.0, np.float32)
        em.get_map_with_name_ref(nm, got[nm])
        cpu.get_map_with_name_ref(nm, want[nm])
    torch.cuda.synchronize()
    res = {"cv2": cv2, "layers": names, "cpu_compare": _compare_plugin_layers("plugin exports", got, want)}
    all_got, all_want = em.get_layers(names), cpu.get_layers(names)
    if list(all_got) != names:
        raise AssertionError(f"get_layers returned {list(all_got)}")
    res["cpu_compare_get_layers"] = _compare_plugin_layers("plugin get_layers", all_got, all_want)
    for nm in names:
        if not np.array_equal(np.ascontiguousarray(all_got[nm]).view(np.uint32), got[nm].view(np.uint32)):
            raise AssertionError(f"get_layers and get_map_with_name_ref disagree on {nm}")
    if np.isfinite(got["smooth"]).mean() < 0.99 or np.count_nonzero(got["semantic_filter"]) < 0.2 * n * n:
        raise AssertionError("implausible plugin layers: smooth has NaN or semantic_filter is mostly empty")
    buf = np.empty((n - 2, n - 2), np.float32)
    res["exports"] = {nm: _timed_call(lambda nm=nm: em.get_map_with_name_ref(nm, buf)) for nm in names}
    res["get_layers_all"] = _timed_call(lambda: em.get_layers(names))

    # the polygon query: profile.py's triangle about the map's centre
    poly = PROFILE_TRIANGLE - PROFILE_TRIANGLE.mean(axis=0) + em.center[:2]
    out = {}
    for tag, m in (("card", em), ("cpu", cpu)):
        result = np.zeros(3)
        count = m.get_polygon_traversability(poly, result)
        ring = np.zeros((count, 2))
        m.get_untraversable_polygon(ring)
        out[tag] = (result, count, ring)
    (r_g, c_g, ring_g), (r_c, c_c, ring_c) = out["card"], out["cpu"]
    if r_g[0] != r_c[0] or r_g[2] != r_c[2] or c_g != c_c or not np.array_equal(ring_g, ring_c):
        raise AssertionError(f"polygon query: card {r_g.tolist()}, {c_g} vertices; CPU {r_c.tolist()}, {c_c}")
    if not abs(r_g[1] - r_c[1]) <= 1e-6 * max(1.0, abs(r_c[1])):
        raise AssertionError(f"polygon query: mean cost {r_g[1]} on the card, {r_c[1]} on the CPU")
    result = np.zeros(3)
    res["polygon"] = {
        "result": r_g.tolist(), "hull_vertices": c_g, "cpu_result": r_c.tolist(),
        **_timed_call(lambda: em.get_polygon_traversability(poly, result)),
    }

    # initialize_map on a fresh map
    init = {}
    pts = INIT_POINTS + em.center
    for tag, dev in (("card", "cuda"), ("cpu", "cpu")):
        m = ElevationMap(em.cfg, device=dev)
        m.move_to(em.center, np.eye(3, dtype=np.float32))
        m.initialize_map(pts, "linear")
        init[tag] = m.get_layers(["elevation", "variance", "is_valid", "upper_bound"])
        if tag == "card":
            card_map = m
    res["initialize_map"] = _compare_layers("initialize_map", init["card"], init["cpu"])
    valid = init["card"]["is_valid"] > 0.5
    if valid.mean() < 0.2 or not np.isfinite(init["card"]["elevation"][valid]).all():
        raise AssertionError(f"initialize_map: {valid.mean():.3f} of cells valid")
    res["initialize_map"]["valid_share"] = float(valid.mean())
    res["initialize_map"].update(_latency_ms(lambda: card_map.initialize_map(pts, "linear"), 3))

    # min_filter at the plugin's default s=5, 5 iterations beside the YAML's s=1, 2
    h, mask = em.state.layers[0], em.state.layers[2]
    res["min_filter_sizes"] = {}
    for size, iters in ((1, 2), (5, 5)):
        a = stencil.min_filter(h, mask, size, iters)
        b = stencil.min_filter(h.cpu(), mask.cpu(), size, iters)
        if not np.array_equal(a.cpu().numpy().view(np.uint32), b.numpy().view(np.uint32)):
            raise AssertionError(f"min_filter s={size} differs between the card and the CPU")
        res["min_filter_sizes"][f"s={size} iterations={iters}"] = _timed_call(
            lambda size=size, iters=iters: stencil.min_filter(h, mask, size, iters)
        )
    torch.cuda.synchronize()
    export_launches = {name: kern.launches for name, kern in kernel_regs.items()}
    check_launches("plugins (exports, polygon query, initialize_map)", export_launches, 1,
                   {"scatter_add_streams": 0, "exact_march": 0})
    res["launches_updates"], res["launches_exports"] = update_launches, export_launches
    log("plugins: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# plane segmentation and the profile entry point
# ---------------------------------------------------------------------------

def _same_terrain_layers(tag: str, got, want) -> dict:
    """Filtered map, elevation and smooth layer of two PlanarTerrains:
    within PLANESEG_TOL on PLANESEG_MIN_SHARE of cells."""
    stats = {}
    for name in ("filtered_map", "elevation", "smooth_planar"):
        a, b = getattr(got, name), getattr(want, name)
        close = (np.isnan(a) & np.isnan(b)) | (np.abs(a - b) <= PLANESEG_TOL)
        finite = np.isfinite(a) & np.isfinite(b)
        stats[name] = {"share_within": float(close.mean()),
                       "max_abs": float(np.abs(a[finite] - b[finite]).max()) if finite.any() else 0.0}
        if not close.mean() >= PLANESEG_MIN_SHARE:
            raise AssertionError(f"{tag}: {name} within {PLANESEG_TOL} on {close.mean():.5f} of cells")
    return stats


def _same_regions(tag: str, got, want) -> dict:
    """Region count, labels and plane tables of two PlanarTerrains; returns
    the largest normal and support differences."""
    if len(got.regions) != len(want.regions):
        raise AssertionError(f"{tag}: {len(got.regions)} regions against {len(want.regions)}")
    worst = {"normal": 0.0, "support": 0.0}
    for rg, rw in zip(got.regions, want.regions):
        dn = float(np.abs(rg.normal - rw.normal).max())
        ds = float(np.abs(rg.support - rw.support).max())
        if rg.label != rw.label or not (dn <= PLANESEG_TOL and ds <= PLANESEG_TOL):
            raise AssertionError(f"{tag}: region {rg.label}/{rw.label} normal off by {dn}, support by {ds}")
        worst = {"normal": max(worst["normal"], dn), "support": max(worst["support"], ds)}
    return worst


def phase_planeseg(kernel_regs, checked: set):
    """Plane decomposition on the card (module docstring, phase 11)."""
    from elevation_mapping_cupy_torch.ops import gridmap_filters as gf
    from elevation_mapping_cupy_torch.planeseg import PlaneDecompositionPipeline
    from elevation_mapping_cupy_torch.planeseg import extract as E

    rng = np.random.default_rng(0)
    h = planeseg_scene(rng)
    n = PLANESEG_N
    pipe = PlaneDecompositionPipeline(resolution=0.04, device="cuda")
    pipe.update(h)  # warm-up
    pipe._stats = {}
    torch.cuda.synchronize()
    for kern in kernel_regs.values():
        kern.launches = 0
    wall = []
    for _ in range(PLANESEG_CALLS):
        t0 = time.perf_counter()
        terrain = pipe.update(h)
        wall.append((time.perf_counter() - t0) * 1e3)
    launches = {name: kern.launches for name, kern in kernel_regs.items()}
    check_launches("planeseg", launches, PLANESEG_CALLS, {"scatter_add_streams": 2, "exact_march": 0})
    totals = np.asarray(pipe._stats["total"]) * 1e3
    report = pipe.timing_report()
    stages = {k: float(np.mean(v) * 1e3) for k, v in pipe._stats.items()}

    # the determinism update also records K1's shapes and the rounds of
    # each fixed-point loop (connected components; the inpainting of the
    # preprocess and of the smooth layer)
    rounds = {"connected_components": [], "inpaint_min_values": []}
    loop = gf.fixed_point

    def recording(key):
        def run(step, x, cap):
            out = loop(step, x, cap)
            rounds[key].append(out[1])
            return out
        return run

    E.fixed_point, gf.fixed_point = recording("connected_components"), recording("inpaint_min_values")
    try:
        with k1_shapes() as shapes:
            again = pipe.update(h)
    finally:
        E.fixed_point = gf.fixed_point = loop
    check_shapes("planeseg", shapes, checked)
    if not np.array_equal(again.labels, terrain.labels):
        raise AssertionError(f"planeseg: a second card update differs in {int((again.labels != terrain.labels).sum())} labels")
    t0 = time.perf_counter()
    cpu = PlaneDecompositionPipeline(resolution=0.04, device="cpu").update(h)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    differing = int((terrain.labels != cpu.labels).sum())
    log(f"planeseg: labels differing from the CPU port in {differing} of {n * n} cells")
    if differing:
        raise AssertionError(f"planeseg: card labels differ from the CPU port's in {differing} cells")
    plane_err = _same_regions("planeseg card against CPU", terrain, cpu)
    layers = _same_terrain_layers("planeseg card against CPU", terrain, cpu)
    if pipe.params.max_labels + 1 != PLANESEG_BINS:
        raise AssertionError("the kernels phase's planeseg cases assume max_labels + 1 == PLANESEG_BINS")
    if len(terrain.regions) < 3 or not np.isfinite(terrain.elevation).all():
        raise AssertionError(f"planeseg: {len(terrain.regions)} regions or a non-finite elevation")

    prof = profile_calls([lambda: pipe.update(h)] * 3)

    # update_batch at B = 16: bench.py's per-map noise on the same scene
    hb = np.stack([h] * PLANESEG_BATCH)
    hb += rng.normal(0, 0.002, hb.shape).astype(np.float32)
    with k1_shapes() as shapes:
        pipe.update_batch(hb)  # warm-up
    check_shapes("planeseg update_batch", shapes, checked)
    torch.cuda.synchronize()
    for kern in kernel_regs.values():
        kern.launches = 0
    batch_ms = []
    for _ in range(PLANESEG_BATCH_CALLS):
        t0 = time.perf_counter()
        batch = pipe.update_batch(hb)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    batch_launches = {name: kern.launches for name, kern in kernel_regs.items()}
    check_launches("planeseg update_batch", batch_launches, PLANESEG_BATCH_CALLS,
                   {"scatter_add_streams": 2, "exact_march": 0})
    for b in (0, PLANESEG_BATCH - 1):
        alone = pipe.update(hb[b])
        if not np.array_equal(batch[b].labels, alone.labels):
            raise AssertionError(f"planeseg: update_batch map {b} differs from its update in "
                                 f"{int((batch[b].labels != alone.labels).sum())} labels")

    ms = np.asarray(wall)
    res = {
        "map": [n, n], "resolution": 0.04, "calls": PLANESEG_CALLS,
        "total_ms_median": float(np.median(totals)), "total_ms_p90": float(np.percentile(totals, 90)),
        "wall_ms_median": float(np.median(ms)), "wall_ms_p90": float(np.percentile(ms, 90)), "wall_ms": ms.tolist(),
        "stages_mean_ms": stages, "device_ms": prof["device_ms_per_update"],
        "device_ops": prof["device_ops_per_update"], "top_device_ms": prof["top_device_ms_per_update"],
        "device_busy_share_of_median": prof["device_ms_per_update"] / float(np.median(ms)),
        "k1_launches_per_update": launches["scatter_add_streams"] / PLANESEG_CALLS,
        "cc_rounds": 1 + rounds["connected_components"][0], "inpaint_rounds": rounds["inpaint_min_values"],
        "regions": len(terrain.regions),
        "label_counts": {int(k): int(v) for k, v in zip(*np.unique(terrain.labels, return_counts=True))},
        "labels_differing_from_cpu": differing, "plane_max_diff_from_cpu": plane_err, "cpu_compare": layers,
        "cpu_port_ms": cpu_ms, "batch": PLANESEG_BATCH, "batch_ms_median": float(np.median(batch_ms)),
        "batch_ms_per_map": float(np.median(batch_ms)) / PLANESEG_BATCH, "launches": launches,
        "batch_launches": batch_launches,
    }
    log("planeseg timing_report:\n" + report)
    log("planeseg: " + json.dumps(res))
    return res


def phase_profile(kernel_regs, checked: set):
    """The port's profile entry point on the card (module docstring, phase
    12); returns its stage table, the launches of its run and the
    comparison of one update of its map with the CPU port."""
    from elevation_mapping_cupy_torch import profile
    from elevation_mapping_cupy_torch.mapper import ElevationMap
    from elevation_mapping_cupy_torch.state import state_from_numpy, state_to_numpy

    for kern in kernel_regs.values():
        kern.launches = 0
    with k1_shapes() as shapes:
        table = profile.main(PROFILE_ARGS)
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in kernel_regs.items()}
    # its warm-up update and PROFILE_ITERS timed ones: geometry 3, colour 1,
    # class_bayesian 1
    check_launches("profile", launches, PROFILE_ITERS + 1, {"scatter_add_streams": 5, "exact_march": 0})
    check_shapes("profile", shapes, checked)

    # one update of the profile's map on the card and on the CPU port from
    # the same state (the first update grows the semantic layers on both)
    cfg = profile.profile_config(PROFILE_POINTS)
    rng = np.random.default_rng(123)
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.0, 0.0, 0.6], np.float32)
    em, cpu = ElevationMap(cfg, device="cuda"), ElevationMap(cfg, device="cpu")
    first = profile.make_points(rng, PROFILE_POINTS)
    em.input_pointcloud(first, profile.CHANNELS, R, t, 0.0, 0.0)
    cpu.input_pointcloud(first, profile.CHANNELS, R, t, 0.0, 0.0)
    em.move_to(np.array([0.01, 0.02, 0.01]), R)
    cpu.state = state_from_numpy(state_to_numpy(em.state), "cpu")
    pts = profile.make_points(rng, PROFILE_POINTS)
    t = np.array([0.01, 0.02, 0.6], np.float32)
    em.input_pointcloud(pts, profile.CHANNELS, R, t, 0.0, 0.0)
    cpu.input_pointcloud(pts, profile.CHANNELS, R, t, 0.0, 0.0)
    names = _semantic_names(em.cfg)
    cmp_stats = _compare_layers("profile update", em.get_layers(names), cpu.get_layers(names), packed=("rgb",))
    cmp_stats.update(_compare_layers(
        "profile update", _state_layers(em.state, em.cfg), _state_layers(cpu.state, cpu.cfg),
        packed=[f"id_max:{n}" for n in em.cfg.semantic_layers], sums=[f"sem_new:{n}" for n in em.cfg.semantic_layers],
    ))
    valid = em.get_layers(["is_valid"])["is_valid"] > 0.5
    if valid.mean() < 0.2:
        raise AssertionError(f"profile: implausible map, {valid.mean():.3f} of cells valid")
    log("profile: " + json.dumps({"args": PROFILE_ARGS, "stages": table, "launches": launches,
                                  "k1_shapes": sorted(shapes), "cpu_compare": cmp_stats}))
    return table, launches, cmp_stats


# ---------------------------------------------------------------------------
# batched multi-map updates
# ---------------------------------------------------------------------------

def _share_within(tag: str, got, want, tol: float, min_share: float, packed=()) -> dict:
    """Per field of two states (NumPy dicts), the share of entries within
    ``tol`` (bit for bit for ``packed``); fails below ``min_share``."""
    stats = {}
    for name in want:
        a, b = got[name], want[name]
        if name in packed:
            close = a.view(np.uint32) == b.view(np.uint32) if a.dtype == np.float32 else a == b
        else:
            close = np.abs(a.astype(np.float64) - b.astype(np.float64)) <= tol
        share = float(close.mean()) if close.size else 1.0
        stats[name] = {"share_within": share,
                       "max_abs": float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max()) if a.size else 0.0}
        if not share >= min_share:
            raise AssertionError(f"{tag}: {name}: {share:.5f} of entries within {tol} (need {min_share})")
    return stats


def batch_inputs(b: int, cfg, seed: int = 0):
    """bench_maps' inputs on the card: ``b`` terrains and clouds from
    ``make_batch_clouds`` (seed ``seed``), all points real, identity
    rotations, no pose noise."""
    from elevation_mapping_cupy_torch.runtime import datagen

    pts, t, _ = datagen.make_batch_clouds(datagen.make_generator(seed, "cuda"), b, cfg.cell_n, cfg.resolution,
                                          BATCH_POINTS)
    mask = torch.ones((b, BATCH_POINTS), dtype=torch.bool, device="cuda")
    R = torch.eye(3, device="cuda").expand(b, 3, 3).contiguous()
    z = torch.zeros(b, device="cuda")
    return pts, mask, R, t, z


def drive_batch(b: int, cfg, weights, kernel_regs, checked: set) -> tuple:
    """One warm-up and BATCH_STEPS timed steps of ``b`` maps; returns the
    numbers, the state before the last step and the last step's inputs."""
    from elevation_mapping_cupy_torch.parallel import batched_update, init_batch

    inputs = batch_inputs(b, cfg)
    states = init_batch(cfg, b, "cuda")
    states = batched_update(states, *inputs, inputs[-1], weights, cfg)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernel_regs.values():
        kern.launches = 0
    lat = []
    with k1_shapes() as shapes:
        for _ in range(BATCH_STEPS):
            before = states
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states = batched_update(states, *inputs, inputs[-1], weights, cfg)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
    launches = {name: kern.launches for name, kern in kernel_regs.items()}
    peak = torch.cuda.max_memory_allocated()
    check_launches(f"batched B={b}", launches, BATCH_STEPS, {"scatter_add_streams": 3, "exact_march": 0})
    check_shapes(f"batched B={b}", shapes, checked)
    valid = states.layers[:, 2] > 0.5
    share = float(valid.float().mean())
    if not (0.02 < share < 0.9) or not bool(torch.isfinite(states.layers[:, 0][valid]).all()):
        raise AssertionError(f"batched B={b}: implausible maps, {share:.4f} of cells valid")
    ms = np.array(lat) * 1e3
    st = states
    prof = profile_calls([lambda: batched_update(st, *inputs, inputs[-1], weights, cfg)] * 3)
    res = {
        "B": b, "points_per_map": BATCH_POINTS, "steps": BATCH_STEPS,
        "step_ms_median": float(np.median(ms)), "step_ms_p90": float(np.percentile(ms, 90)),
        "step_ms": ms.tolist(), "maps_per_s": b / float(np.median(ms)) * 1e3,
        "points_per_s": b * BATCH_POINTS / float(np.median(ms)) * 1e3,
        "device_ms_per_step": prof["device_ms_per_update"],
        "device_ops_per_step": prof["device_ops_per_update"],
        "device_busy_share_of_median_step": prof["device_ms_per_update"] / float(np.median(ms)),
        "top_device_ms_per_step": prof["top_device_ms_per_update"],
        "peak_memory_bytes": int(peak), "launches": launches, "k1_shapes": sorted(shapes), "valid_share": share,
    }
    log(f"batched B={b}: " + json.dumps(res))
    return res, before, states, inputs


def _batch_image_case(states, cfg, rng):
    """BATCH_IMAGE_MAPS maps of ``states`` with rgb and mask layers and
    every cell valid (the heights are the batch's), one image each from a
    camera looking down from 2 m near its map's centre, a little apart from
    map to map."""
    from elevation_mapping_cupy_torch.state import MapState

    b = BATCH_IMAGE_MAPS
    channels = ("rgb", "mask")
    icfg = cfg.replace(semantic_layers=channels, image_channel_fusions=(
        ("rgb", "color"), ("mask", "exponential"), ("default", "exponential")))
    n = cfg.cell_n
    sem = lambda dt: torch.zeros((b, 2, n, n), dtype=dt, device="cuda")  # noqa: E731
    maps = MapState(*(x[:b].clone() for x in states))._replace(
        semantic=sem(torch.float32), sem_new=sem(torch.float32), id_max=sem(torch.int64))
    maps.layers[:, 2] = 1.0
    H, W = BATCH_IMAGE_SHAPE
    img = np.concatenate([rng.integers(0, 256, (b, 3, H, W)), rng.random((b, 1, H, W))], axis=1).astype(np.float32)
    f = 0.625 * W  # a 3.2 m x 2.4 m footprint from 2 m
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    R = np.array([[1.0, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    centers = maps.center.cpu().numpy()
    ts = np.stack([-R @ (centers[i] + np.array([0.3 * i, -0.2, 2.0], np.float32)) for i in range(b)])
    dev = lambda x: torch.as_tensor(np.ascontiguousarray(x), device="cuda")  # noqa: E731
    args = (dev(img), dev(np.broadcast_to(R, (b, 3, 3))), dev(ts), dev(np.broadcast_to(K, (b, 3, 3))),
            torch.zeros((b, 5), device="cuda"))
    return icfg, channels, maps, args


def phase_batched(kernel_regs, checked: set):
    """bench_maps' batched path on the card (module docstring, phase 13);
    returns the numbers per batch size and the checks' results."""
    from elevation_mapping_cupy_torch import MapConfig, core
    from elevation_mapping_cupy_torch.nn.traversability import DEFAULT_WEIGHT_FILE, load_weights_npz
    from elevation_mapping_cupy_torch.parallel import (
        batch_stats, batched_input_image, batched_move_to, batched_update, checkpoint, distributed,
        init_batch, shard_states,
    )
    from elevation_mapping_cupy_torch.state import state_to_numpy, take_map, MapState

    cfg = MapConfig(max_points=BATCH_POINTS)  # bench_maps' config
    weights = load_weights_npz(DEFAULT_WEIGHT_FILE).to("cuda")
    out = {}
    for b in BATCH_SIZES:
        res, before, states, inputs = drive_batch(b, cfg, weights, kernel_regs, checked)
        out[b] = res
        if b != max(BATCH_SIZES):
            continue
        big, big_before, big_inputs = states, before, inputs
    b = max(BATCH_SIZES)
    states, before, inputs = big, big_before, big_inputs
    checks = {}
    # maps 0 and B-1 against their own per-map update on the card
    for m in (0, b - 1):
        pts, mask, R, t, _ = (x[m] for x in inputs)
        single = core.update_pointcloud(take_map(before, m), pts, mask, R, t, 0.0, 0.0, weights, cfg)
        checks[f"map{m}_vs_per_map"] = _share_within(
            f"batched map {m} against its per-map update", state_to_numpy(take_map(states, m)),
            state_to_numpy(single), BATCH_TOL, CMP_MIN_SHARE)
    # a B = 4 batch from the same states on the CPU port
    k = BATCH_CPU_MAPS
    cpu_before = MapState(*(x[:k].cpu() for x in before))
    cpu_weights = load_weights_npz(DEFAULT_WEIGHT_FILE)  # Module.to moves in place: a second copy
    cpu_out = batched_update(cpu_before, *(x[:k].cpu() for x in inputs), inputs[-1][:k].cpu(), cpu_weights, cfg)
    checks["cpu_b4"] = _share_within(
        "batched B=4 card against the CPU port", state_to_numpy(MapState(*(x[:k] for x in states))),
        state_to_numpy(cpu_out), CMP_ATOL, CMP_MIN_SHARE)
    # per-map recentering
    rng = np.random.default_rng(13)
    positions = torch.from_numpy(rng.uniform(-0.6, 0.6, (b, 3)).astype(np.float32)).cuda()
    Rs = torch.eye(3, device="cuda").expand(b, 3, 3).contiguous()
    moved = batched_move_to(states, positions, Rs, cfg)
    for m in range(b):
        one = core.move_to(take_map(states, m), positions[m], Rs[m], cfg)
        for name, x, y in zip(MapState._fields, take_map(moved, m), one):
            if not torch.equal(x, y):
                raise AssertionError(f"batched_move_to: map {m} field {name} differs from its per-map move_to")
    checks["move_to"] = "equal bits, all maps"
    # one image per map, both occlusion modes
    icfg, channels, maps, args = _batch_image_case(states, cfg, rng)
    for mode in ("shadow", "bresenham"):
        mcfg = icfg.replace(image_occlusion_mode=mode)
        got = batched_input_image(maps, *args, mcfg, channels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = batched_input_image(maps, *args, mcfg, channels)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        per = []
        for m in range(BATCH_IMAGE_MAPS):
            one = core.input_image(take_map(maps, m), *(a[m] for a in args), mcfg, channels)
            per.append(one.semantic)
        want = torch.stack(per)
        filled = float((got.semantic[:, 1] != 0).float().mean())
        checks[f"image_{mode}"] = _share_within(
            f"batched_input_image ({mode})", {"rgb": got.semantic[:, 0].cpu().numpy(), "mask": got.semantic[:, 1].cpu().numpy()},
            {"rgb": want[:, 0].cpu().numpy(), "mask": want[:, 1].cpu().numpy()}, 1e-6, 1.0, packed=("rgb",))
        checks[f"image_{mode}"]["filled_share"] = filled
        checks[f"image_{mode}"]["ms"] = ms
        if filled < 0.05:
            raise AssertionError(f"batched_input_image ({mode}): only {filled:.4f} of cells fused")
    # NCCL on the one card: a one-process group
    import socket
    import shutil

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    nb = min(16, b)
    if not distributed.initialize(f"localhost:{port}", 1, 0):
        raise AssertionError("distributed.initialize did not bring up the NCCL group")
    ckpt_dir = tempfile.mkdtemp(prefix="batched_ckpt_")
    try:
        mesh = distributed.pod_mesh(("host", "chip"))
        if tuple(mesh.mesh.shape) != (1, 1) or mesh.device_type != "cuda":
            raise AssertionError(f"pod mesh {tuple(mesh.mesh.shape)} on {mesh.device_type}, expected (1, 1) on cuda")
        local = shard_states(init_batch(cfg, nb, "cuda"), mesh, "host")
        feed = distributed.HostFeed(nb, mesh, axis="host")
        fed = [feed.globalize(x[:nb].cpu().numpy()) for x in inputs]
        stepped = batched_update(local, *fed, fed[-1], weights, cfg)
        stats = {k: float(v) for k, v in batch_stats(stepped).items()}
        checkpoint.save(ckpt_dir, stepped)
        back = checkpoint.restore(ckpt_dir, template=local)
        for name, x, y in zip(MapState._fields, stepped, back):
            if not (x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)):
                raise AssertionError(f"checkpoint: field {name} did not round-trip bit for bit")
        backend = torch.distributed.get_backend()
    finally:
        distributed.shutdown()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    plain = {k: float(v) for k, v in batch_stats(stepped).items()}
    if stats != plain or not 0.0 < stats["frac_valid_mean"] < 1.0:
        raise AssertionError(f"batch_stats through NCCL {stats} against no group {plain}")
    checks["nccl"] = {"backend": backend, "mesh": [1, 1], "stats": stats, "checkpoint": "equal bits",
                      "group_torn_down": not torch.distributed.is_initialized()}
    res = {"per_batch": {str(k): v for k, v in out.items()}, "checks": checks}
    log("batched checks: " + json.dumps(checks))
    return res


# ---------------------------------------------------------------------------
# the runtime service, the sensor sidecar and the DINO ViT
# ---------------------------------------------------------------------------

def raw_records(pts: np.ndarray, rng: np.random.Generator) -> bytes:
    """A cloud as PointCloud2-style interleaved records: x, y, z and one
    padding float per POINT_STEP-byte record, a share of them with a NaN
    coordinate (no return)."""
    rec = np.zeros((len(pts), POINT_STEP // 4), np.float32)
    rec[:, :3] = pts
    bad = np.flatnonzero(rng.random(len(pts)) < SERVICE_NAN_SHARE)
    rec[bad, rng.integers(0, 3, bad.size)] = np.nan
    return rec.tobytes()


def service_frames(n: int, seed: int):
    """(R, t, robot position, raw bytes) of n frames of the scene along
    ``robot_pose``'s arc."""
    rng = np.random.default_rng(seed)
    frames = []
    for k in range(n):
        R, t, pos = robot_pose(k)
        frames.append((R, t, pos, raw_records(scene_cloud(rng, MAIN_POINTS, R, t), rng)))
    return frames


def drive_service(svc, frames, sync: bool, first: int = 0) -> list:
    """Frame by frame: the pose update, a producer thread pushing the raw
    bytes into the service's ring, then ``spin_once`` at the frame's time on
    this thread (every torch call happens here). Returns the host time of
    each ``spin_once``, ended by a synchronise when ``sync``."""
    import queue
    import threading

    requests, acks = queue.Queue(), queue.Queue()

    def producer():
        for item in iter(requests.get, None):
            R, t, raw, stamp = item
            acks.put(svc.enqueue_raw_pointcloud(raw, MAIN_POINTS, POINT_STEP, [0, 4, 8], ["x", "y", "z"], R, t,
                                                stamp=stamp))

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    lat = []
    try:
        for k, (R, t, pos, raw) in enumerate(frames, start=first):
            svc.update_pose(pos, R)
            requests.put((R, t, raw, SERVICE_PERIOD * k))
            if not acks.get(timeout=120):
                raise AssertionError(f"service: the ring rejected frame {k}")
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = svc.spin_once(now=SERVICE_PERIOD * (k + 1))
            if sync:
                torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            if n != 1:
                raise AssertionError(f"service: spin_once processed {n} frames, expected 1")
    finally:
        requests.put(None)
        th.join(timeout=60)
    return lat


def service_image_frame(svc):
    """One 480x640 rgb frame from a camera 1.5 m above a point 0.6 m ahead
    of the map's centre, looking down (as phase 9)."""
    from elevation_mapping_cupy_torch.runtime.service import SensorFrame

    H, W = IMAGE_SHAPE
    img = np.random.default_rng(13).integers(0, 256, (3, H, W)).astype(np.float32)
    K = np.array([[400.0, 0, W / 2], [0, 400.0, H / 2], [0, 0, 1]], np.float32)
    R = np.array([[1.0, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    t = -R @ (svc.mapper.center + np.array([0.6, -0.2, 1.5], np.float32))
    return SensorFrame(kind="image", channels=("rgb",), data=img, R=R, t=t, K=K, D=np.zeros(5, np.float32))


def service_queries(svc) -> dict:
    """get_submap (map frame and a yawed request frame) and CheckSafety on
    one polygon about the map's centre."""
    c = svc.mapper.center
    yaw = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    out = {f"submap:{k}": v for k, v in svc.get_submap(c[:2] + 0.5, (2.0, 1.6), ["elevation", "traversability"]).items()}
    out.update({f"submap_yawed:{k}": v for k, v in svc.get_submap(
        c[:2], (1.6, 1.6), ["elevation"], frame_transform=(yaw, np.array([0.0, 0.0, 0.5]))).items()})
    (safe, trav, poly), = svc.check_safety([PROFILE_TRIANGLE + c[:2]])
    return {"layers": out, "safety": (safe, trav, poly.shape)}


def check_native() -> dict:
    """The native deinterleave, rgb packing and frame ring against their
    plain versions at MAIN_POINTS points, bit for bit, and their host time."""
    from elevation_mapping_cupy_torch.runtime import native

    rng = np.random.default_rng(14)
    R, t, _ = robot_pose(0)
    raw = raw_records(scene_cloud(rng, MAIN_POINTS, R, t), rng)
    got = native.deinterleave(raw, MAIN_POINTS, POINT_STEP, [0, 4, 8])
    plain = native.deinterleave(raw, MAIN_POINTS, POINT_STEP, [0, 4, 8], plain=True)
    if got.shape != plain.shape or not np.array_equal(got.view(np.uint32), plain.view(np.uint32)):
        raise AssertionError("native: deinterleave differs from its plain version")
    r, g, b = (rng.integers(0, 256, MAIN_POINTS).astype(np.uint8) for _ in range(3))
    if not np.array_equal(native.pack_rgb(r, g, b).view(np.uint32), native.pack_rgb(r, g, b, plain=True).view(np.uint32)):
        raise AssertionError("native: pack_rgb differs from its plain version")
    ring, plain_ring = native.FrameRing(capacity=4), native.FrameRing(capacity=4, plain=True)
    payload = np.frombuffer(raw, np.uint8)
    for rg in (ring, plain_ring):
        rg.push(b"PC2", payload)
    (h, p), (ph, pp) = ring.pop(), plain_ring.pop()
    if h != ph or not np.array_equal(p, pp):
        raise AssertionError("native: the frame ring returns another frame than its plain version")

    def host_ms(fn, calls=20):
        fn()
        ts = []
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    res = {
        "points": MAIN_POINTS, "point_step": POINT_STEP, "kept": int(got.shape[0]), "equal_to_plain": True,
        "deinterleave_ms": host_ms(lambda: native.deinterleave(raw, MAIN_POINTS, POINT_STEP, [0, 4, 8])),
        "deinterleave_plain_ms": host_ms(lambda: native.deinterleave(raw, MAIN_POINTS, POINT_STEP, [0, 4, 8], plain=True)),
        "pack_rgb_ms": host_ms(lambda: native.pack_rgb(r, g, b)),
        "ring_push_pop_ms": host_ms(lambda: (ring.push(b"PC2", payload), ring.pop())),
        "ring_bytes": len(raw),
    }
    log("native: " + json.dumps(res))
    return res


def sensor_frame(k: int):
    """A synthetic 480x640 depth+rgb frame of the scene from a camera 1.5 m
    above the robot, looking down (optical frame: x right, y down, z
    forward), 1 cm of depth noise and 1 % of pixels without a return; and
    the camera's intrinsics and pose (camera to map)."""
    rng = np.random.default_rng(100 + k)
    H, W = IMAGE_SHAPE
    K = np.array([[400.0, 0, W / 2], [0, 400.0, H / 2], [0, 0, 1]], np.float32)
    R = np.array([[1.0, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    _, _, pos = robot_pose(k)
    cam = pos + np.array([0.6, -0.2, 1.5], np.float32)
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    x = cam[0] + (u - K[0, 2]) / K[0, 0] * cam[2]
    y = cam[1] - (v - K[1, 2]) / K[1, 1] * cam[2]
    h = np.zeros((H, W), np.float32)
    for x0, y0, x1, y1, bh in BOXES:
        h[(x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)] = bh
    depth = (cam[2] - h + rng.normal(0.0, 0.01, (H, W))).astype(np.float32)
    depth[rng.random((H, W)) < 0.01] = 0.0
    rgb = np.clip(np.stack([80 + 300 * h, 120 - 100 * h, np.full_like(h, 60)]) + rng.normal(0, 20, (3, H, W)), 0, 255)
    return depth, rgb.astype(np.uint8), K, R, cam


def drive_sensor_semantic(kernel_regs, checked: set) -> dict:
    """The semantic sensor path: PointcloudSensorNode with the full-width
    DINO vit_small/8 at bf16 on the card turns SENSOR_FRAMES depth+rgb frames
    into clouds with SENSOR_CHANNELS, which a MappingService on
    semantic_mem.yaml's tables fuses (rgb -> color, the rest ->
    class_average): one K1 launch per fusion present, 5 per frame. The
    same clouds through the CPU port's service give the same map."""
    from elevation_mapping_cupy_torch.runtime.service import MappingService, SensorFrame
    from elevation_mapping_cupy_torch.sensor.pointcloud import PointcloudParameter, PointcloudSensorNode

    node = PointcloudSensorNode(PointcloudParameter(channels=SENSOR_CHANNELS), semantic_model="dino_vits8",
                                device="cuda")
    if node.model.cfg.variant != "vit_small" or node.model.cfg.compute_dtype != torch.bfloat16:
        raise AssertionError(f"sensor: the node runs {node.model.cfg}")
    cfg = semantic_config()
    svc, cpu = (MappingService.from_settings(cfg, DEPLOYED_EXTRAS, device=d) for d in ("cuda", "cpu"))
    depth, rgb, K, R, cam = sensor_frame(0)
    cloud, names = node(depth, K, rgb=rgb)  # warm-up: cuBLAS plans, the layers grow
    svc.enqueue(SensorFrame(kind="pointcloud", channels=tuple(names), data=cloud, R=R, t=cam))
    cpu.enqueue(SensorFrame(kind="pointcloud", channels=tuple(names), data=cloud, R=R, t=cam))
    svc.spin_once(now=0.0)
    cpu.spin_once(now=0.0)
    torch.cuda.synchronize()
    predict_ms = []
    for _ in range(SENSOR_PREDICT_CALLS):
        t0 = time.perf_counter()
        node.model.predict(rgb)
        predict_ms.append((time.perf_counter() - t0) * 1e3)
    for kern in kernel_regs.values():
        kern.launches = 0
    lat, node_ms, clouds = [], [], []
    with k1_shapes() as shapes:
        for k in range(1, 1 + SENSOR_FRAMES):
            depth, rgb, K, R, cam = sensor_frame(k)
            svc.update_pose(robot_pose(k)[2], np.eye(3))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cloud, names = node(depth, K, rgb=rgb)
            t1 = time.perf_counter()
            svc.enqueue(SensorFrame(kind="pointcloud", channels=tuple(names), data=cloud, R=R, t=cam))
            if svc.spin_once(now=SERVICE_PERIOD * k) != 1:
                raise AssertionError("sensor: the frame was not mapped")
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            node_ms.append((t1 - t0) * 1e3)
            clouds.append((cloud, names, R, cam))
    launches = {name: kern.launches for name, kern in kernel_regs.items()}
    check_launches("sensor (semantic)", launches, SENSOR_FRAMES, {"scatter_add_streams": 5, "exact_march": 0})
    check_shapes("sensor (semantic)", shapes, checked)
    if names != ["x", "y", "z", "rgb", *SENSOR_CHANNELS] or not np.isfinite(cloud).all():
        raise AssertionError(f"sensor: cloud columns {names} or non-finite values")
    for k, (cloud, names, R, cam) in enumerate(clouds, start=1):
        cpu.update_pose(robot_pose(k)[2], np.eye(3))
        cpu.enqueue(SensorFrame(kind="pointcloud", channels=tuple(names), data=cloud, R=R, t=cam))
        cpu.spin_once(now=SERVICE_PERIOD * k)
    layer_names = _semantic_names(cfg)
    cmp_stats = _compare_layers("sensor (semantic)", svc.mapper.get_layers(layer_names),
                                cpu.mapper.get_layers(layer_names), packed=("rgb",))
    # the camera's footprint on the ground, in cells
    footprint = IMAGE_SHAPE[0] * IMAGE_SHAPE[1] * (1.5 / K[0, 0] / cfg.resolution) ** 2
    fused = min(np.count_nonzero(np.nan_to_num(v)) for v in svc.mapper.get_layers(list(SENSOR_CHANNELS)).values())
    if fused < 0.5 * footprint:
        raise AssertionError(f"sensor: a DINO channel was fused into {fused} cells of a {footprint:.0f}-cell footprint")
    res = {
        "frames": SENSOR_FRAMES, "image": list(IMAGE_SHAPE), "points": int(len(clouds[-1][0])),
        "channels": list(SENSOR_CHANNELS), "model": "dino_vits8 (vit_small/8, bf16)",
        "predict_ms_median": float(np.median(predict_ms)), "predict_ms": predict_ms,
        "node_ms_median": float(np.median(node_ms)),
        "frame_latency_ms_median": float(np.median(lat)), "frame_latency_ms": lat,
        "launches": launches, "k1_launches_per_frame": 5, "k1_shapes": sorted(shapes), "cpu_compare": cmp_stats,
    }
    log("sensor (semantic): " + json.dumps(res))
    return res


def phase_service(kernel_regs, checked: set):
    """The runtime service on the card (module docstring, phase 14)."""
    from elevation_mapping_cupy_torch.runtime.service import MappingService

    native_res = check_native()
    cfg = deployed_config()
    frames = service_frames(SERVICE_WARMUP + SERVICE_FRAMES, seed=12)
    published = ([], [])
    svc, cpu = (MappingService.from_settings(cfg, DEPLOYED_EXTRAS, device=dev) for dev in ("cuda", "cpu"))
    for s, pub in zip((svc, cpu), published):
        s.enable_raw_ingest()
        s.add_publisher("elevation_map_raw", LAYERS, SERVICE_PUBLISH_FPS, lambda out, pub=pub: pub.append(sorted(out)))
    drive_service(svc, frames[:SERVICE_WARMUP], sync=True)
    torch.cuda.reset_peak_memory_stats()
    for kern in kernel_regs.values():
        kern.launches = 0
    with k1_shapes() as shapes:
        lat = drive_service(svc, frames[SERVICE_WARMUP:], sync=True, first=SERVICE_WARMUP)
    launches = {name: kern.launches for name, kern in kernel_regs.items()}
    peak = torch.cuda.max_memory_allocated()
    check_launches("service", launches, SERVICE_FRAMES, {"scatter_add_streams": 3, "exact_march": 0})
    check_shapes("service", shapes, checked)

    image = service_image_frame(svc)
    for kern in kernel_regs.values():
        kern.launches = 0
    svc.enqueue(image)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.spin_once(now=SERVICE_PERIOD * (len(frames) + 1))
    torch.cuda.synchronize()
    image_ms = (time.perf_counter() - t0) * 1e3
    image_launches = {name: kern.launches for name, kern in kernel_regs.items()}
    check_launches("service (image)", image_launches, 1, {"scatter_add_streams": 0, "exact_march": 0})
    queries = service_queries(svc)
    query_ms = _latency_ms(lambda: service_queries(svc), calls=5)

    # the same frames, pose updates, image and queries through the CPU port's service
    drive_service(cpu, frames, sync=False)
    cpu.enqueue(image)
    cpu.spin_once(now=SERVICE_PERIOD * (len(frames) + 1))
    cpu_queries = service_queries(cpu)
    names = LAYERS + ["rgb"]
    cmp_stats = _compare_layers("service final map", svc.mapper.get_layers(names), cpu.mapper.get_layers(names),
                                packed=("rgb",))
    cmp_stats.update(_compare_layers("service submaps", queries["layers"], cpu_queries["layers"]))
    safe, trav, shape = queries["safety"]
    if (safe, shape) != cpu_queries["safety"][::2] or abs(trav - cpu_queries["safety"][1]) > CMP_ATOL:
        raise AssertionError(f"service: CheckSafety {queries['safety']} on the card, {cpu_queries['safety']} on the CPU")
    for key in ("frames_processed", "frames_dropped"):
        if getattr(svc.stats, key) != getattr(cpu.stats, key):
            raise AssertionError(f"service: statistics {key} differ from the CPU service's")
    if published[0] != published[1] or not published[0]:
        raise AssertionError(f"service: {len(published[0])} publishes on the card, {len(published[1])} on the CPU")
    valid = svc.mapper.get_layers(["is_valid"])["is_valid"] > 0.5
    if valid.mean() < 0.2:
        raise AssertionError(f"service: implausible map, {valid.mean():.3f} of cells valid")

    more = service_frames(3, seed=15)
    prof = profile_calls([
        lambda R=R, t=t, pos=pos, raw=raw, k=k: (
            svc.update_pose(pos, R),
            svc.enqueue_raw_pointcloud(raw, MAIN_POINTS, POINT_STEP, [0, 4, 8], ["x", "y", "z"], R, t),
            svc.spin_once(now=SERVICE_PERIOD * (len(frames) + 2 + k)))
        for k, (R, t, pos, raw) in enumerate(more)
    ])
    ms = np.array(lat) * 1e3
    prof["device_busy_share_of_median_latency"] = prof["device_ms_per_update"] / float(np.median(ms))
    res = {
        "frames": SERVICE_FRAMES, "points": MAIN_POINTS, "point_step": POINT_STEP,
        "latency_ms_median": float(np.median(ms)), "latency_ms_p90": float(np.percentile(ms, 90)),
        "latency_ms": ms.tolist(), "frames_per_s": SERVICE_FRAMES / float(ms.sum() / 1e3),
        "stats_latency_ms": svc.stats.last_update_latency * 1e3, "stats_fps": svc.stats.pointcloud_process_fps,
        "publishes": len(published[0]), "launches": launches, "k1_launches_per_frame": 3,
        "k1_shapes": sorted(shapes), "peak_memory_bytes": int(peak), "image_frame_ms": image_ms,
        "image_launches": image_launches, "queries": query_ms, "safety": list(map(str, queries["safety"])),
        "cpu_compare": cmp_stats, "profile": prof, "native": native_res,
    }
    log("service: " + json.dumps(res))
    res["sensor"] = drive_sensor_semantic(kernel_regs, checked)
    return res


def vit_flops(cfg, b: int, h: int, w: int) -> float:
    """Multiply-adds x 2 of ``dino_featurize`` on b images of h x w."""
    n_p = (h // cfg.patch_size) * (w // cfg.patch_size)
    n, d = n_p + 1, cfg.embed_dim
    hidden = int(d * cfg.mlp_ratio)
    block = 2 * n * (3 * d * d + d * d + 2 * d * hidden) + 2 * 2 * n * n * d
    head = 2 * n_p * (d * cfg.dim + d * d + d * cfg.dim)
    return float(b * (2 * n_p * 3 * cfg.patch_size**2 * d + cfg.depth * block + head))


def phase_dino():
    """The DINO ViT on the card (module docstring, phase 15)."""
    from elevation_mapping_cupy_torch.sensor import dino as D

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("dino: TF32 is on; float32 products must stay float32")
    rng = np.random.default_rng(17)
    res = {"out_dtype_products": D._has_out_dtype()}
    img = np.random.default_rng(16).normal(0, 1, (1, 3, DINO_SIZE, DINO_SIZE)).astype(np.float32)
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = D.ViTConfig(variant="vit_small", patch_size=8, compute_dtype=dtype)
        for dev in ("cuda", "cpu"):
            model = D.DinoFeaturizer(cfg=cfg, seed=0, device=dev).model
            x = torch.from_numpy(img).to(dev)
            outs[dtype, dev] = [D.vit_features(model, x, cfg)[0].cpu(), D.dino_featurize(model, x, cfg)[1].cpu()]
    for dtype in (torch.float32, torch.bfloat16):
        stats = {}
        for i, tag in enumerate(("tokens", "code")):
            g, c = outs[dtype, "cuda"][i], outs[dtype, "cpu"][i]
            if g.shape != c.shape or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"dino {dtype}: {tag} of shape {tuple(g.shape)} or non-finite")
            diff = (g - c).abs()
            st = {"max_abs": float(diff.max()), "mean_abs": float(diff.mean())}
            if dtype == torch.float32:
                st["tol"] = CMP_ATOL
                ok = st["max_abs"] <= CMP_ATOL
            else:
                # bf16 rounding noise on this image: the CPU port's bf16
                # result against its float32 one
                gap = (c - outs[torch.float32, "cpu"][i]).abs()
                st["bf16_gap_max"], st["bf16_gap_mean"] = float(gap.max()), float(gap.mean())
                ok = st["max_abs"] <= st["bf16_gap_max"] and st["mean_abs"] <= st["bf16_gap_mean"]
            stats[tag] = st
            if not ok:
                raise AssertionError(f"dino {dtype}: {tag} off the CPU port by {st}")
        res[str(dtype).split(".")[-1]] = stats
    log("dino vs CPU (vit_small/8, 224x224): " + json.dumps(res))

    # bench.py::bench_dino's shapes: vit_small/16, DINO_BATCH images of 224x224, bf16
    cfg = D.ViTConfig(variant="vit_small", patch_size=16)
    model = D.init_vit_params(torch.Generator().manual_seed(0), cfg).cuda()
    imgs = torch.from_numpy(rng.normal(0, 1, (DINO_BATCH, 3, DINO_SIZE, DINO_SIZE)).astype(np.float32)).cuda()
    fn = lambda: D.dino_featurize(model, imgs, cfg)[1]  # noqa: E731
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(DINO_ITERS):
        out = fn()
    torch.cuda.synchronize()
    batch_s = (time.perf_counter() - t0) / DINO_ITERS
    if out.shape != (DINO_BATCH, cfg.dim, DINO_SIZE // 16, DINO_SIZE // 16) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"dino bench: code of shape {tuple(out.shape)} or non-finite")
    prof = profile_calls([fn] * 3)
    flops = vit_flops(cfg, DINO_BATCH, DINO_SIZE, DINO_SIZE)
    bench = {
        "variant": "vit_small/16", "batch": DINO_BATCH, "image": [DINO_SIZE, DINO_SIZE], "dtype": "bfloat16",
        "batch_ms": batch_s * 1e3, "frames_per_s": DINO_BATCH / batch_s, "events_ms": _events_ms(fn, DINO_ITERS),
        "peak_memory_bytes": int(torch.cuda.max_memory_allocated()), "flops": flops,
        "bound_ms_bf16_peak": flops / BF16_FLOPS_PER_S * 1e3, **prof,
    }
    bench["tflops_per_s"] = flops / (bench["device_ms_per_update"] / 1e3) / 1e12
    log("dino bench (bench_dino shapes): " + json.dumps(bench))
    res["bench"] = bench
    return res


def profile_updates(em, rng, n_updates: int = 5, pose: int = 300, make_cloud=scene_cloud,
                    channels=("x", "y", "z")) -> dict:
    """Where one update's time goes: torch.profiler over back-to-back
    updates of MAIN_POINTS points seen from robot pose ``pose`` (clouds made
    beforehand by ``make_cloud``, no map motion): device time and device
    operations per update, the host clock under the profiler, and the
    kernels that take the most device time."""
    R, t, _ = robot_pose(pose)
    clouds = [make_cloud(rng, MAIN_POINTS, R, t) for _ in range(n_updates)]
    return profile_calls([lambda pts=pts: em.input_pointcloud(pts, list(channels), R, t, 0.0, 0.0) for pts in clouds])


def profile_calls(calls) -> dict:
    """torch.profiler over the given calls, run back to back; per call (the
    keys say "update"): device time, device operations, the host clock under
    the profiler, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    n_updates = len(calls)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for call in calls:
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:12]
    # cuBLAS (nvjet, *gemm*) and CUTLASS matrix products
    gemm = [e for e in dev if any(s in e.key.lower() for s in ("gemm", "nvjet", "cutlass", "xmma"))]
    return {
        "updates": n_updates,
        "wall_ms_per_update": wall_us / n_updates / 1e3,
        "device_ms_per_update": dev_us / n_updates / 1e3,
        "device_busy_share_profiled": dev_us / wall_us,
        "device_ops_per_update": sum(e.count for e in dev) / n_updates,
        "top_device_ms_per_update": {
            e.key[:80]: round(e.self_device_time_total / n_updates / 1e3, 4) for e in top
        },
        "matmul_share": sum(e.self_device_time_total for e in gemm) / dev_us if dev_us else 0.0,
        "matmul_kernels": sorted({e.key[:70] for e in gemm}),
    }


SEMANTIC_CASES = ("features3", "features8", "colour4", "colour3", "count1", "cube_class_max")
PLANESEG_CASES = ("planeseg_moments", "planeseg_label_bad", "planeseg_batch_moments", "planeseg_batch_label_bad")
PROFILE_CASES = ("profile_count", "profile_fusion", "profile_cube", "profile_class_bayesian", "profile_colour4")
BATCH_CASES = tuple(f"batch{b}_{kind}" for b in BATCH_SIZES for kind in ("count", "fusion", "cube"))
SENSOR_CASES = ("sensor_count", "sensor_fusion", "sensor_cube", "sensor_features3")


def kernels_line(cases, launches, march_cases, exact_launches, n_main: int, path_launches: dict) -> dict:
    """One entry per kernel. K1's numbers are those of one update's three
    launches at the main path's cloud size (error counting, fusion, cube),
    summed and, under ``cases``, each on its own together with the semantic
    fusions', plane segmentation's, the profile path's, the batched
    phase's and the semantic sensor path's shapes, and its launches on the
    polar main path; its ``max_abs_err`` is the largest of
    every timed case. K2's are those
    of the gated march of n_main rays (the router's first choice) and its
    launches on the exact path. ``launches_by_path`` holds every driven
    path's count, each read after a run that began with the counts at 0.
    ``ms`` is the call as its caller pays for it, ``device_ms`` the device's
    own time."""
    march = march_cases[(n_main, True)]
    shapes = [cases[(c, n_main)] for c in ("count", "fusion", "cube")]
    listed = (shapes + [cases[(c, n_main)] for c in SEMANTIC_CASES]
              + [cases[(c, PLANESEG_N * PLANESEG_N)] for c in PLANESEG_CASES]
              + [cases[(c, PROFILE_BUCKET)] for c in PROFILE_CASES]
              + [cases[(c, BATCH_POINTS)] for c in BATCH_CASES]
              + [cases[(c, SENSOR_BUCKET)] for c in SENSOR_CASES])
    total = lambda key: sum(s[key] for s in shapes)  # noqa: E731
    by_path = lambda name: {path: counts[name] for path, counts in path_launches.items()}  # noqa: E731
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
                "launches_by_path": by_path("scatter_add_streams"),
                "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
                "ms": total("kernel_ms"),
                "device_ms": total("device_ms"),
                "plain_ms": total("plain_ms"),
                "bound_ms": total("bound_ms"),
                "bound_by": "bytes",
                "library_ms": total("library_ms"),
                "cases": [
                    {"case": s["case"], "path": s["path"], "max_abs_err": s["max_abs_err"], "ms": s["kernel_ms"],
                     "device_ms": s["device_ms"], "bound_ms": s["bound_ms"], "bound_by": "bytes",
                     "plain_ms": s["plain_ms"], "library_ms": s["library_ms"]}
                    for s in listed
                ],
            },
            {
                "name": "exact_march",
                "route": "cuda",
                "source": "elevation_mapping_cupy_torch/csrc/exact_march.cu",
                "replaces": "scripts/probe_pallas_gather.py:38",
                "function": "k_take, k_take2, k_scat, k_smin, k_sort, k_taa, k_taa2, k_take2d",
                "checked": True,
                "launches": exact_launches["exact_march"],
                "launches_by_path": by_path("exact_march"),
                "max_abs_err": max(c["max_abs_err"] for c in march_cases.values()),
                "ms": march["kernel_ms"],
                "device_ms": march["device_ms"],
                "plain_ms": march["plain_ms"],
                "bound_ms": march["bound_ms"],
                "bound_by": march["bound_by"],
                "library_ms": None,
            },
        ]
    }


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
    cfg = deployed_config()
    cases = timed("kernels", phase_kernels, cfg)
    main_res, launches, mapped_state = timed("main", phase_main, cfg, regs)
    march_cases, fresh_cases = timed("march", phase_march, cfg, mapped_state)
    exact_res, exact_launches = timed("exact", phase_exact, cfg, regs)
    timed("replay", phase_replay, cfg, regs)
    sem_map, mem_res, allf_res = timed("semantic", phase_semantic, cfg, regs)
    image_res = timed("image", phase_image, sem_map, regs)
    plugin_res = timed("plugins", phase_plugins, sem_map, regs)
    checked = checked_shapes(cases)
    planeseg_res = timed("planeseg", phase_planeseg, regs, checked)
    profile_table, profile_launches, profile_cmp = timed("profile", phase_profile, regs, checked)
    batched_res = timed("batched", phase_batched, regs, checked)
    service_res = timed("service", phase_service, regs, checked)
    dino_res = timed("dino", phase_dino)
    log(f"total: {time.perf_counter() - t0:.1f} s")
    path_launches = {
        "polar": launches, "exact": exact_launches, "semantic_mem": mem_res["launches"],
        "semantic_all_fusions": allf_res["launches"],
        "image_shadow": image_res["shadow"]["launches"], "image_bresenham": image_res["bresenham"]["launches"],
        "plugins_updates": plugin_res["launches_updates"], "plugins_exports": plugin_res["launches_exports"],
        "planeseg": planeseg_res["launches"], "planeseg_batch": planeseg_res["batch_launches"],
        "profile": profile_launches,
        **{f"batched_B{b}": batched_res["per_batch"][str(b)]["launches"] for b in BATCH_SIZES},
        "service": service_res["launches"], "service_image": service_res["image_launches"],
        "sensor_semantic": service_res["sensor"]["launches"],
    }
    line = kernels_line(cases, launches, march_cases, exact_launches, MAIN_POINTS, path_launches)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({
                "card": smi, "kernels_line": line, "polar": main_res, "exact": exact_res,
                "semantic_mem": mem_res, "semantic_all_fusions": allf_res, "image": image_res,
                "plugins": plugin_res, "planeseg": planeseg_res, "batched": batched_res,
                "profile": {"stages": profile_table, "launches": profile_launches, "cpu_compare": profile_cmp},
                "service": service_res, "dino": dino_res,
                "scatter_cases": list(cases.values()),
                "march_cases": list(march_cases.values()) + list(fresh_cases.values()),
            }, f, indent=1)
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
