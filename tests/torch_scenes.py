"""Scenes, configs and checks shared by the port's tests and ``chip_smoke.py``.

The card tests (``tests/test_torch_cuda.py``) run where neither JAX nor
PyYAML is installed, so this module imports neither: the deployed config,
its service keys and the plugin file are literals here, which CPU tests hold
to the YAML files.

Run as a module, it is one process of a world spawned by a card test:

    python -m tests.torch_scenes --spatial-worker PORT RANK SIZE DIR [--spatial-backend gloo|nccl]
    python -m tests.torch_scenes --example-world-worker DIR <the sharded example's worker arguments>
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN_POINTS = 131072
POINT_STEP = 16             # x, y, z and one padding float
IMAGE_SHAPE = (480, 640)
NAN_SHARE = 0.01            # share of raw records without a return
PLANESEG_N = 202
# card against CPU on one update from the same state: 1e-4 per layer on all
# but a small share of cells (atan2/tan/sin/cos round an ulp apart on the
# card and on the CPU, which can move a ray into the neighbouring bin)
CMP_ATOL = 1e-4
CMP_MIN_SHARE = 0.999
# K1 value streams against the plain version, relative to max(1, |sum|):
# both sides add float32 in an order the atomics pick, and a cell near the
# sensor sums thousands of points (one ulp of a sum of 2000 is 1.2e-4)
VALUE_TOL = 2e-4
# initialize_map's sparse points, (x, y, z) about the map's centre
INIT_POINTS = np.array([
    [1.5, 1.2, 0.1], [-1.8, 1.0, 0.25], [1.0, -2.2, -0.05], [-1.4, -1.6, 0.3],
    [0.1, 0.2, 0.15], [2.4, -0.4, 0.0], [-0.3, 2.6, 0.2], [-2.5, -0.2, 0.05],
])
MEM_CHANNELS = ("rgb", "grass", "tree", "person")
ALL_FUSIONS_TABLE = (
    ("f_avg", "average"), ("f_bayes", "bayesian_inference"), ("f_dir", "class_bayesian"), ("max_.*", "class_max"),
)
ALL_FUSIONS_CHANNELS = ("f_avg", "f_bayes", "f_dir", "max_a", "max_b")
LAYERS = ["elevation", "variance", "is_valid", "traversability", "time",
          "upper_bound", "is_upper_bound", "normal_x", "normal_y", "normal_z"]
# configs/plugin_config.yaml as a literal (tests/test_torch_plugins.py holds
# it to the YAML): per plugin its type, layer name, fill_nan,
# is_height_layer and extra_params
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
# two plugins over semantic_mem.yaml's class layers
CLASS_LAYERS = ["grass", "tree", "person"]
SEMANTIC_PLUGIN_SETTINGS = (
    ("semantic_filter", "semantic_filter", False, False, {"classes": CLASS_LAYERS}),
    ("features_pca", "features_pca", False, False, {"process_layer_names": CLASS_LAYERS}),
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
# one map sharded over processes: 2 (rows) and 4 (2x2 tiles)
SPATIAL_STEPS = 4            # one warm-up and three timed updates a world
SPATIAL_WORLDS = {2: ((2,), ("x",), None), 4: ((2, 2), ("x", "y"), "y")}
SPATIAL_TIMEOUT_S = 300
SPATIAL_TOL = 1e-5
SPATIAL_MOVE = {"exact1024": (0.5, -0.3, 0.1), "polar1024": (1.0, -0.6, 0.0)}
SPATIAL_LAUNCHES = {"exact1024": {"scatter_add_streams": 2, "exact_march": 1, "dilation_fill": 1,
                                  "polar_evaluate": 0, "polar_scan": 0, "points_associate": 0, "points_fuse": 0},
                    "polar1024": {"scatter_add_streams": 3, "exact_march": 0, "dilation_fill": 1,
                                  "polar_evaluate": 1, "polar_scan": 1, "points_associate": 0, "points_fuse": 0}}


def deployed_config():
    """``configs/core_param.yaml`` as a ``MapConfig`` literal.
    tests/test_torch_core.py checks that this equals the port's
    ``load_config("configs/core_param.yaml")``."""
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
# synthetic scenes
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
    same: tests/test_torch_cuda.py)."""
    from elevation_mapping_cupy_torch.planeseg import extract as E

    return E.extract_planes(E.preprocess(torch.from_numpy(h)), 0.04, E.PlaneSegParams()).labels.numpy()


def raw_records(pts: np.ndarray, rng: np.random.Generator) -> bytes:
    """A cloud as PointCloud2-style interleaved records: x, y, z and one
    padding float per POINT_STEP-byte record, a share of them with a NaN
    coordinate (no return)."""
    rec = np.zeros((len(pts), POINT_STEP // 4), np.float32)
    rec[:, :3] = pts
    bad = np.flatnonzero(rng.random(len(pts)) < NAN_SHARE)
    rec[bad, rng.integers(0, 3, bad.size)] = np.nan
    return rec.tobytes()


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


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def compare_layers(tag: str, got: dict, want: dict, packed=(), min_share: float = CMP_MIN_SHARE, where=None,
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


def compare_plugin_layers(tag: str, got: dict, want: dict) -> dict:
    """Card against CPU plugin layers: semantic_filter bit for bit on every
    cell, features_pca channel by channel, the float layers within CMP_ATOL
    on CMP_MIN_SHARE of cells with NaN exactly where the CPU has NaN."""
    stats = {}
    floats = [nm for nm in want if nm not in ("semantic_filter", "features_pca")]
    for nm in floats:
        if not np.array_equal(np.isnan(got[nm]), np.isnan(want[nm])):
            raise AssertionError(f"{tag}: {nm} has NaN in other cells than on the CPU")
    stats.update(compare_layers(tag, {nm: got[nm] for nm in floats}, {nm: want[nm] for nm in floats}))
    if "semantic_filter" in want:
        stats.update(compare_layers(tag, {"semantic_filter": got["semantic_filter"]},
                                     {"semantic_filter": want["semantic_filter"]},
                                     packed=("semantic_filter",), min_share=1.0))
    if "features_pca" in want:
        stats["features_pca"] = {"channels": pca_channels(got["features_pca"], want["features_pca"])}
    return stats


def share_within(tag: str, got, want, tol: float, min_share: float, packed=()) -> dict:
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
# K1 and K2 on the card against their plain versions
# ---------------------------------------------------------------------------

def cell_indices(rng, b: int, n: int, n_cells: int) -> np.ndarray:
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


def check_scatter_case(rng, label: str, b: int, n: int, n_cells: int, exact, int_max: int = 1, idx_np=None,
                       n_real=None) -> tuple:
    """K1 against its plain version on the card at one shape: streams
    marked in ``exact`` hold integers 0..int_max and must be equal bit for
    bit, the others within VALUE_TOL relative. ``idx_np`` gives the (b, n)
    indices where the default density does not fit the caller; points from
    ``n_real`` on are masked off, as the mapper's padding is. Returns (the
    case's numbers, its (idx, mask, values) on the card)."""
    from elevation_mapping_cupy_torch.ops import cuda_scatter as cs

    k = len(exact)
    idx = torch.from_numpy(cell_indices(rng, b, n, n_cells) if idx_np is None else idx_np).cuda()
    mask_np = rng.random((b, n)) > 0.15
    if n_real is not None:
        mask_np[:, n_real:] = False
    mask = torch.from_numpy(mask_np).cuda()
    vals_np = rng.normal(0.5, 0.3, (b, k, n)).astype(np.float32)
    for s, e in enumerate(exact):
        if e:
            vals_np[:, s] = rng.integers(0, int_max + 1, (b, n))
    vals = torch.from_numpy(vals_np).cuda()

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
    return res, (idx, mask, vals)


def checked_shapes(cases) -> set:
    """The (B, K, N, n_cells) of K1 cases' numbers."""
    return {(c["B"], c["K"], c["N"], c["n_cells"]) for c in cases}


def march_inputs(state, cfg, n_rays: int, rng, gated: bool, pose: int = 21):
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


def datagen_exact_step(b: int, n: int, device, steps: int = 1, aged: bool = False):
    """A datagen batch of ``b`` maps of ``n`` points on the default map with
    the exact cleanup (the cell ``datagen_exact.b64_ep8``'s widths): fresh
    maps through ``steps`` batched steps, each with new terrains (step i's
    clouds from generator seed i), the last one's cleanup inputs recorded.
    ``aged`` passes the recency gate (7 time updates) before the last step,
    so that its march can hit the cells the earlier steps mapped. Returns
    (config, the last step's arguments after the state, the state before
    it, K2's (pack, world, valid, t, gate) built from the recorded inputs by
    the plain parts, the recorded cleanup's (layers, normal, point
    association, inlier counts, sensor position))."""
    from elevation_mapping_cupy_torch import MapConfig, core
    from elevation_mapping_cupy_torch.nn.traversability import default_weights
    from elevation_mapping_cupy_torch.ops import raycast
    from elevation_mapping_cupy_torch.parallel import batched_update, init_batch
    from elevation_mapping_cupy_torch.runtime import datagen

    cfg = MapConfig(max_points=n, raycast_mode="exact")
    weights = default_weights().to(device)

    def step_args(i):
        pts, t, _ = datagen.make_batch_clouds(datagen.make_generator(i, device), b, cfg.cell_n, cfg.resolution, n)
        z = torch.zeros(b, device=device)
        return (pts, torch.ones((b, n), dtype=torch.bool, device=device),
                torch.eye(3, device=device).expand(b, 3, 3).contiguous(), t, z, z, weights, cfg)

    state = init_batch(cfg, b, device)
    for i in range(steps - 1):
        state = batched_update(state, *step_args(i))
    if aged:
        for _ in range(7):
            state = core.update_time(state, cfg)
    args = step_args(steps - 1)
    seen, cleanup = [], raycast.visibility_cleanup_exact

    def recording(layers, normal, assoc, inlier_cnt, t_, *rest, **kw):
        seen.append((layers, normal, assoc, inlier_cnt, t_))
        return cleanup(layers, normal, assoc, inlier_cnt, t_, *rest, **kw)

    raycast.visibility_cleanup_exact = recording
    try:
        batched_update(state, *args)
    finally:
        raycast.visibility_cleanup_exact = cleanup
    if len(seen) != 1:
        raise AssertionError(f"datagen exact step B={b}: {len(seen)} cleanups in one step")
    layers, normal, assoc, inlier_cnt, t = seen[0]
    pack = raycast.exact_precompute(layers, normal, inlier_cnt, cfg)
    return cfg, args, state, (pack, assoc.world, assoc.valid, t, raycast.exact_gate(pack, cfg)), seen[0]


def check_exact_cleanup(cfg, snap, label: str):
    """The exact cleanup of whole maps on the card in one K2 launch
    (``cuda_march.exact_cleanup``) against the same cleanup composed of its
    parts (``visibility_cleanup_exact`` on the whole map as a block: the
    pack, the gate and the update in PyTorch around K2 on the pack): every
    layer but validity and the survivor fractions equal, validity within
    VALUE_TOL of max(1, |decrement|) (float atomics add a cell's decrements
    in any order). Returns the one-launch cleanup's (layers, aux)."""
    from elevation_mapping_cupy_torch.ops import cuda_march as cm, raycast
    from elevation_mapping_cupy_torch.ops.geometry import Block

    layers, normal, assoc, inlier_cnt, t = snap
    before = cm.KERNEL.launches
    got, aux = raycast.visibility_cleanup_exact(layers, normal, assoc, inlier_cnt, t, cfg, with_aux=True)
    torch.cuda.synchronize()
    if cm.KERNEL.launches != before + 1:
        raise AssertionError(f"{label}: {cm.KERNEL.launches - before} K2 launches")
    want, want_aux = raycast.visibility_cleanup_exact(layers, normal, assoc, inlier_cnt, t, cfg, with_aux=True,
                                                      block=Block.whole(cfg.cell_n, cfg.cell_n))
    for row in (0, 1, 3, 4, 5, 6):
        if not torch.equal(got[:, row], want[:, row]):
            raise AssertionError(f"{label}: layer {row} differs in {int((got[:, row] != want[:, row]).sum())} cells")
    dec = (layers[:, 2] - want[:, 2]).abs().clamp(min=1.0)
    rel = float(((got[:, 2] - want[:, 2]).abs() / dec).max())
    if rel > VALUE_TOL:
        raise AssertionError(f"{label}: validity off by {rel} (relative) > {VALUE_TOL}")
    if not torch.equal(aux["gate_survivor_frac"], want_aux["gate_survivor_frac"]):
        raise AssertionError(f"{label}: survivor fractions {aux} vs {want_aux}")
    return got, aux


def check_block_march(state, cfg, world, valid, t, blk, gated: bool, whole, label: str) -> dict:
    """K2 with block bounds against its plain version on the same block,
    and against ``whole``, the unblocked launch: the block's hit counts and
    upper bounds are the whole map's there, its decrement within VALUE_TOL."""
    from elevation_mapping_cupy_torch.ops import cuda_march as cm, raycast

    sl = (slice(blk.r0, blk.r0 + blk.h), slice(blk.c0, blk.c0 + blk.w))
    pack = raycast.exact_precompute(state.layers[:, sl[0], sl[1]], state.normal[:, sl[0], sl[1]],
                                    torch.zeros_like(state.layers[0, sl[0], sl[1]]), cfg)
    gate = raycast.exact_gate(pack, cfg, blk) if gated else None
    got = cm.exact_march(pack, world, valid, t, cfg, gate, blk)
    want = cm.exact_march_reference(pack, world, valid, t, cfg, gate, block=blk)
    torch.cuda.synchronize()
    n = cfg.cell_n
    part = lambda x: x.reshape(n, n)[sl].reshape(-1)  # noqa: E731
    whole = whole._replace(dec=part(whole.dec), hits=part(whole.hits), ubmin=part(whole.ubmin))
    for tag, a, b in (("plain version", got, want), ("whole map", got, whole)):
        if not torch.equal(a.hits, b.hits) or not torch.equal(a.ubmin, b.ubmin):
            raise AssertionError(f"{label}: hit counts or upper bounds differ from the {tag}'s")
        rel = float(((a.dec - b.dec).abs() / b.dec.abs().clamp(min=1.0)).max())
        if rel > VALUE_TOL:
            raise AssertionError(f"{label}: decrement off the {tag}'s by {rel} (relative)")
    if gated and not torch.equal(got.counts, want.counts):
        raise AssertionError(f"{label}: segment counts {got.counts.tolist()} vs {want.counts.tolist()}")
    return {"case": label, "rays": int(world.shape[0]), "block": list(blk[:4]), "gated": gated,
            "hits": int(got.hits.sum()), "ub_cells": int(torch.isfinite(got.ubmin).sum())}


def check_march_blocks(state, ecfg, rng) -> list:
    """K2 with block bounds: on an aged deployed map, two row blocks and a
    tile, gate on and off; then at the spatial exact config, every block
    its worlds launch K2 on (no gate, as that config resolves), on a map of
    one card update. Returns the cases' numbers."""
    from elevation_mapping_cupy_torch import core
    from elevation_mapping_cupy_torch.nn.traversability import DEFAULT_WEIGHT_FILE, load_weights_npz
    from elevation_mapping_cupy_torch.ops import cuda_march as cm, geometry, raycast
    from elevation_mapping_cupy_torch.ops.geometry import Block
    from elevation_mapping_cupy_torch.state import init_state

    out = []
    n = ecfg.cell_n
    for gated in (True, False):
        pack, world, valid, t, gate = march_inputs(state, ecfg, MAIN_POINTS, rng, gated)
        whole = cm.exact_march(pack, world, valid, t, ecfg, gate)
        for blk in (Block(0, 0, n // 2 + 7, n, n, n), Block(n // 2 - 7, 0, n - n // 2 + 7, n, n, n),
                    Block(n // 2 - 7, n // 2 - 7, n - n // 2 + 7, n - n // 2 + 7, n, n)):
            out.append(check_block_march(
                state, ecfg, world, valid, t, blk, gated, whole,
                f"exact march N={MAIN_POINTS} block {tuple(blk[:4])} {'gated' if gated else 'ungated'}"))
    scfg, n_pts = spatial_configs()["exact1024"]
    pts, R, t_np = spatial_clouds("exact1024", n_pts)[0]
    w = load_weights_npz(DEFAULT_WEIGHT_FILE).to("cuda")
    t = torch.from_numpy(t_np).cuda()
    mapped = core.update_pointcloud(init_state(scfg, "cuda"), torch.from_numpy(pts).cuda(),
                                    torch.ones(n_pts, dtype=torch.bool, device="cuda"), torch.from_numpy(R).cuda(),
                                    t, 0.0, 0.0, w, scfg)
    for _ in range(7):
        mapped = core.update_time(mapped, scfg)
    pts, R, _ = spatial_clouds("exact1024", n_pts)[1]
    assoc = geometry.associate_points(torch.from_numpy(pts).cuda(), torch.ones(n_pts, dtype=torch.bool, device="cuda"),
                                      torch.from_numpy(R).cuda(), t, scfg)
    pack = raycast.exact_precompute(mapped.layers, mapped.normal, torch.zeros_like(mapped.layers[0]), scfg)
    whole = cm.exact_march(pack, assoc.world, assoc.valid, t, scfg)
    blocks = {s.block for _, _, s in spatial_shards(scfg)} | {Block.whole(scfg.cell_n, scfg.cell_n)}
    for blk in sorted(blocks):
        out.append(check_block_march(mapped, scfg, assoc.world, assoc.valid, t, blk, False, whole,
                                     f"spatial exact1024 march N={n_pts} block {tuple(blk[:4])}"))
    return out


def march_block_shapes(cases: list) -> set:
    """The (rays, block rows, block columns, gated) that blocked march cases
    checked: the shapes ``k2_shapes`` records."""
    return {(c["rays"], c["block"][2], c["block"][3], c["gated"]) for c in cases}


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


@contextlib.contextmanager
def k2_shapes():
    """Records the (rays a map, block rows, block columns, gated) of every
    K2 call made inside."""
    from elevation_mapping_cupy_torch.ops import cuda_march as cm, raycast

    shapes, march = set(), cm.exact_march

    def recording(pack, world, valid, t, cfg, gate=None, block=None):
        h, w = (cfg.cell_n, cfg.cell_n) if block is None else (block.h, block.w)
        shapes.add((int(world.shape[-2]), h, w, gate is not None))
        return march(pack, world, valid, t, cfg, gate, block)

    raycast.cuda_march.exact_march = recording
    try:
        yield shapes
    finally:
        raycast.cuda_march.exact_march = march


# ---------------------------------------------------------------------------
# D4 and D5 against their plain versions
# ---------------------------------------------------------------------------

def point_stage_inputs(cfg, b: int, n: int, device, channels: int = 0, seed: int = 0, nan: bool = True) -> tuple:
    """(points (b, n, 3 + channels), pad_mask, R, t, layers) as
    ``core.update_batch_aux`` hands them to the association, on ``cfg``'s
    map: heights near 0 with variances on both sides of the drift
    compensation's inlier limit and a third of the cells invalid; points
    within 0.3 m of the map's heights, some beyond the map and on its border
    ring, some above the validity ramp and some too close to the sensor, 5 %
    padding (half of it zeros), 1 % NaN with ``nan`` (the card's
    cast puts them on cell 0; the CPU's cannot index them). Map 0's sensor is
    unrotated at the map's centre, and an eighth of its points lie exactly
    on cell edges (x and y the float32 of k * resolution), where the cell
    index's true division decides the cell; the other maps' sensors are
    tilted and turned."""
    rng = np.random.default_rng(seed)
    c, res = cfg.cell_n, cfg.resolution
    half = 0.5 * c * res
    layers = np.zeros((b, 7, c, c), np.float32)
    layers[:, 0] = rng.normal(0.0, 0.05, (b, c, c))
    layers[:, 1] = rng.uniform(0.0005, 0.1, (b, c, c))
    layers[:, 2] = rng.random((b, c, c)) < 0.67
    layers[:, 3] = rng.random((b, c, c))
    layers[:, 4:] = rng.normal(0.0, 1.0, (b, 3, c, c))
    R = np.zeros((b, 3, 3))
    t = np.zeros((b, 3))
    for k in range(b):
        yaw, tilt = (0.0, 0.0) if k == 0 else (rng.uniform(-math.pi, math.pi), rng.uniform(-0.2, 0.2))
        cy, sy, ct, st = math.cos(yaw), math.sin(yaw), math.cos(tilt), math.sin(tilt)
        R[k] = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]]) @ np.array(
            [[ct, 0.0, st], [0.0, 1.0, 0.0], [-st, 0.0, ct]])
        t[k] = (0.0, 0.0, 0.6) if k == 0 else (rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), rng.uniform(0.4, 0.8))
    R, t = R.astype(np.float32), t.astype(np.float32)
    world = np.stack([rng.uniform(-half - 0.3, half + 0.3, (b, n)), rng.uniform(-half - 0.3, half + 0.3, (b, n)),
                      rng.normal(0.0, 0.1, (b, n))], axis=-1)
    ring = rng.random((b, n)) < 0.02  # on the border ring's cells
    world[..., 0] = np.where(ring, np.sign(world[..., 0]) * (half - 0.5 * res), world[..., 0])
    high = rng.random((b, n)) < 0.03  # above the ramp or the height limit
    world[..., 2] = np.where(high, rng.uniform(0.3, 2.0, (b, n)), world[..., 2])
    near = rng.random((b, n)) < 0.01  # too close to the sensor
    world = np.where(near[..., None], t[:, None, :] + rng.uniform(-0.25, 0.25, (b, n, 3)), world)
    pts = np.einsum("bji,bnj->bni", R.astype(np.float64), world - t[:, None, :].astype(np.float64))
    pts = pts.astype(np.float32)
    edges = rng.random(n) < 0.125
    k_xy = rng.integers(-c // 2, c // 2 + 1, (2, n))
    pts[0, edges, 0] = (k_xy[0, edges] * res).astype(np.float32)
    pts[0, edges, 1] = (k_xy[1, edges] * res).astype(np.float32)
    pad = rng.random((b, n)) >= 0.05
    pts[~pad & (rng.random((b, n)) < 0.5)] = 0.0
    if nan:
        pts[rng.random((b, n)) < 0.01] = np.nan
    if channels:
        pts = np.concatenate([pts, rng.random((b, n, channels)).astype(np.float32)], axis=-1)
    return tuple(torch.from_numpy(x).to(device) for x in (pts, pad, R, t, layers))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors are equal in dtype, shape and bits (float32 NaNs
    by their bits)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return torch.equal(a, b)


def check_point_stages(label: str, cfg, inputs) -> dict:
    """D4 and D5 against their plain versions on the card, on ``inputs``
    (``point_stage_inputs``): every field of the association, the cells'
    rows and K1's error-counting streams bit for bit, the inlier counts
    equal, the error sums within 1e-6 of max(1, |sum|) of the float64 sum
    of the plain version's terms (``max_rel_err``; the plain version's own
    float32 sum's is ``plain_rel_err``) and equal in bits over two
    launches; then, with the drift gate open (h_delta from the
    kernel's error sums), the fusion's four streams and active mask bit for
    bit. One launch of each kernel a call. Returns the case's counts."""
    from elevation_mapping_cupy_torch.ops import point_stages as ps
    from elevation_mapping_cupy_torch.ops import pointcloud as pc
    from elevation_mapping_cupy_torch.ops import scatter

    def fault(what):
        raise AssertionError(f"point stages {label}: {what}")

    points, pad, R, t, layers = inputs
    b, n = pad.shape
    before = (ps.ASSOCIATE_KERNEL.launches, ps.FUSE_KERNEL.launches)
    got = ps.associate(*inputs, cfg)
    want = ps._associate(*inputs, cfg)
    for name in got.assoc._fields:
        if not same_bits(getattr(got.assoc, name), getattr(want.assoc, name)):
            fault(f"{name} differs from the plain version")
    for name in ("rows", "counted", "error_cnt"):
        if not same_bits(getattr(got, name).contiguous(), getattr(want, name).contiguous()):
            fault(f"{name} differs from the plain version")
    # the error sums against the float64 sum of the plain version's terms
    terms = torch.where(want.counted[:, 0] > 0, want.assoc.world[..., 2] - want.rows[..., 0], 0.0).double()
    exact = terms.sum(-1)

    def off(x):
        return float(((x.double() - exact).abs() / exact.abs().clamp(min=1.0)).max()) if b else 0.0

    rel, plain_rel = off(got.error_sum), off(want.error_sum)
    if not rel <= 1e-6:
        fault(f"error_sum {rel} off the float64 sum of its terms (the plain version's: {plain_rel})")
    if not same_bits(ps.associate(*inputs, cfg).error_sum, got.error_sum):
        fault("error_sum differs between two launches")
    h, w = layers.shape[-2:]
    sums = scatter.scatter_add_streams_2d(h, w, got.assoc.flat_idx, got.counted, got.assoc.mask)
    counts = pc.ErrorCounts(sums[:, 0], sums[:, 1], got.error_sum, got.error_cnt)
    zero = torch.zeros(b, device=layers.device)
    gate_cfg = cfg.replace(enable_drift_compensation=True, min_height_drift_cnt=0, max_drift=1e9)
    _, _, _, h_delta = pc.apply_drift_compensation(layers, counts, zero + 1.0, zero, zero, zero, gate_cfg)
    streams, active = ps.fuse(got, h_delta, counts.point_cnt, cfg)
    want_streams, want_active = ps._fuse(got, h_delta, counts.point_cnt, cfg)
    if not (same_bits(streams, want_streams) and same_bits(active, want_active)):
        fault("the fusion's streams differ from the plain version")
    torch.cuda.synchronize()
    if (ps.ASSOCIATE_KERNEL.launches - before[0], ps.FUSE_KERNEL.launches - before[1]) != (2, 1):
        fault("not one launch of each kernel a call")
    return {"case": label, "B": b, "N": n, "row_floats": points.shape[-1], "masked": int(got.assoc.mask.sum()),
            "inliers": int(got.error_cnt.sum()), "fused": int(streams[:, 2].sum()),
            "outliers": int(streams[:, 3].sum()), "maps_drifted": int((h_delta != 0).sum()),
            "max_rel_err": rel, "plain_rel_err": plain_rel}


# ---------------------------------------------------------------------------
# one map sharded over processes
# ---------------------------------------------------------------------------

def spatial_configs():
    """name -> (MapConfig, points per update): the JAX package's 1024-cell
    spatial test config (tests/test_parallel.py, 8192 points; the exact
    march) and core_param.yaml at 1024 x 1024 cells of 0.04 m (the polar
    cleanup) at the main path's cloud size."""
    from elevation_mapping_cupy_torch.config import MapConfig

    return {
        "exact1024": (MapConfig(resolution=0.1, map_length=102.2, max_ray_length=0.5, max_points=8192), 8192),
        "polar1024": (deployed_config().replace(map_length=40.88), MAIN_POINTS),
    }


def spatial_clouds(name: str, n: int) -> list:
    """The SPATIAL_STEPS updates' (points, R, t) of a spatial config, from
    seed 7: tests/test_parallel.py's 1024 cloud, or the scene seen from the
    robot's first poses."""
    rng = np.random.default_rng(7)
    out = []
    for k in range(SPATIAL_STEPS):
        if name == "exact1024":
            pts = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
            pts[:, 2] = rng.uniform(-0.1, 0.3, n).astype(np.float32)
            out.append((pts, np.eye(3, dtype=np.float32), np.array([0, 0, 0.5], np.float32)))
        else:
            R, t, _ = robot_pose(k)
            out.append((scene_cloud(rng, n, R, t), R, t))
    return out


def spatial_shards(cfg) -> list:
    """Every (world size, rank, SpatialShard) of the spatial worlds for
    ``cfg``, from the layout alone."""
    from elevation_mapping_cupy_torch.parallel.halo import Axis
    from elevation_mapping_cupy_torch.parallel.spatial import SpatialSharding, ghost_width

    out = []
    for size, (shape, _, col_axis) in SPATIAL_WORLDS.items():
        nr, nc = shape[0], (shape[1] if col_axis else 1)
        for rank in range(size):
            i, j = divmod(rank, nc)
            lay = SpatialSharding(Axis(tuple(range(nr)), i, None), Axis(tuple(range(nc)), j, None))
            out.append((size, rank, lay.shard(cfg.cell_n, ghost_width(cfg))))
    return out


def spatial_k1_cases(rng) -> list:
    """K1 at the spatial worlds' launches: error counting and point fusion
    of each config on every block its worlds give a process, and on the
    whole map; their cube is the main path's."""
    cases = []
    for name, (scfg, n) in spatial_configs().items():
        for cells in sorted({scfg.cell_n ** 2} | {s.block.h * s.block.w for _, _, s in spatial_shards(scfg)}):
            for kind, exact in (("error counting", (True, True)), ("point fusion", (False, False, True, True))):
                cases.append(check_scatter_case(rng, f"spatial {name} {kind} N={n} cells={cells}", 1, n, cells,
                                                exact)[0])
    return cases


def spatial_worker(port: int, rank: int, size: int, folder: str, backend: str = "gloo") -> None:
    """One process of a spatial world on the card: a group of ``size``
    processes, every spatial config sharded over its mesh, SPATIAL_STEPS
    updates (the first a warm-up), the launches and shapes of the others,
    the gathered map and a sharded move_to. Results go to ``folder``.
    Under gloo every process computes on the current card (the halos go
    through host memory); under NCCL each takes card ``rank`` modulo the
    cards it sees."""
    from elevation_mapping_cupy_torch import kernels
    from elevation_mapping_cupy_torch.nn.traversability import DEFAULT_WEIGHT_FILE, load_weights_npz
    from elevation_mapping_cupy_torch.parallel import distributed, make_mesh, spatial
    from elevation_mapping_cupy_torch.state import init_state

    if not distributed.initialize(f"localhost:{port}", size, rank, device="cpu" if backend == "gloo" else "cuda"):
        raise RuntimeError("no process group")
    shape, names, col_axis = SPATIAL_WORLDS[size]
    mesh = make_mesh(shape, names)
    regs = kernels.registered_kernels()
    w = load_weights_npz(DEFAULT_WEIGHT_FILE).to("cuda")
    report = {}
    for name, (cfg, n) in spatial_configs().items():
        state = spatial.shard_state_spatial(init_state(cfg, "cuda"), mesh, "x", col_axis)
        step = spatial.spatial_update_pointcloud(mesh, cfg, "x", (), col_axis)
        mask = torch.ones(n, dtype=torch.bool, device="cuda")
        with k1_shapes() as k1, k2_shapes() as k2:
            for k, (pts, R, t) in enumerate(spatial_clouds(name, n)):
                if k == 1:
                    for kern in regs.values():
                        kern.launches = 0
                    k1.clear()
                    k2.clear()
                args = (torch.from_numpy(pts).cuda(), mask, torch.from_numpy(R).cuda(), torch.from_numpy(t).cuda())
                state = step(state, *args, 0.0, 0.0, w)
        torch.cuda.synchronize()
        launches = {kname: kern.launches for kname, kern in regs.items()}
        whole = spatial.gather_spatial(state, mesh, "x", col_axis)
        moved = spatial.spatial_move_to(state, torch.tensor(SPATIAL_MOVE[name], device="cuda"),
                                        torch.eye(3, device="cuda"), cfg, mesh, "x", col_axis)
        moved = spatial.gather_spatial(moved, mesh, "x", col_axis)
        report[name] = {"launches": launches, "k1_shapes": sorted(k1), "k2_shapes": sorted(k2)}
        if rank == 0:
            np.savez(os.path.join(folder, f"{name}.npz"), layers=whole.layers.cpu().numpy(),
                     normal=whole.normal.cpu().numpy(), moved=moved.layers.cpu().numpy())
    with open(os.path.join(folder, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    distributed.shutdown()


def run_spatial_world(size: int, backend: str = "gloo") -> tuple:
    """Spawn a spatial world of ``size`` processes (``backend`` "gloo": all
    on one card; "nccl": one card each) and wait for it; a rank that fails
    or outlasts SPATIAL_TIMEOUT_S fails. Returns (per-rank reports, rank 0's
    gathered maps by config)."""
    import socket

    folder = tempfile.mkdtemp(prefix=f"spatial{size}_")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_scenes", "--spatial-worker", str(port), str(r),
                               str(size), folder, "--spatial-backend", backend],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for r in range(size)]
    try:
        outs = [p.communicate(timeout=SPATIAL_TIMEOUT_S)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"spatial world of {size}: rank {r} exited {p.returncode}:\n{text[-6000:]}")
    reports = []
    for r in range(size):
        with open(os.path.join(folder, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    maps = {}
    for name in spatial_configs():
        with np.load(os.path.join(folder, f"{name}.npz")) as z:
            maps[name] = {k: z[k] for k in z.files}
    return reports, maps


def spatial_reference(name: str, cfg, n: int, weights) -> dict:
    """The unsharded card update of a spatial config's SPATIAL_STEPS clouds
    and its ``move_to``, as NumPy layers, normals and moved layers."""
    from elevation_mapping_cupy_torch import core
    from elevation_mapping_cupy_torch.state import init_state

    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    ref = init_state(cfg, "cuda")
    for pts, R, t in spatial_clouds(name, n):
        args = (torch.from_numpy(pts).cuda(), mask, torch.from_numpy(R).cuda(), torch.from_numpy(t).cuda())
        ref = core.update_pointcloud(ref, *args, 0.0, 0.0, weights, cfg)
    moved = core.move_to(ref, torch.tensor(SPATIAL_MOVE[name], device="cuda"), torch.eye(3, device="cuda"), cfg)
    return {"layers": ref.layers.cpu().numpy(), "normal": ref.normal.cpu().numpy(), "moved": moved.layers.cpu().numpy()}


def check_spatial_world(size: int, reports: list, maps: dict, refs: dict, checked: set, march_checked: set) -> None:
    """A spatial world's launches and shapes per process (K1 and K2 only at
    checked shapes), and its gathered maps against the unsharded card
    update."""
    for name in spatial_configs():
        per_rank = [r[name] for r in reports]
        for rank, rep_ in enumerate(per_rank):
            tag = f"spatial {name} world {size} rank {rank}"
            check_launches(tag, rep_["launches"], SPATIAL_STEPS - 1, SPATIAL_LAUNCHES[name])
            k1 = {tuple(x) for x in rep_["k1_shapes"]}
            if not k1 or not k1 <= checked:
                raise AssertionError(f"{tag}: K1 shapes {sorted(k1 - checked)} not checked (or no launch)")
            k2 = {tuple(x) for x in rep_["k2_shapes"]}
            if not k2 <= march_checked or (SPATIAL_LAUNCHES[name]["exact_march"] and not k2):
                raise AssertionError(f"{tag}: K2 shapes {sorted(k2 - march_checked)} not checked")
        share_within(f"spatial {name} world {size}", maps[name], refs[name], SPATIAL_TOL, CMP_MIN_SHARE)


def example_world_worker(argv) -> None:
    """One process of the sharded example's world (``--example-world-worker
    DIR <worker arguments>``): the example's own worker, with K1's shapes
    recorded and every count read after it, written to DIR."""
    from elevation_mapping_cupy_torch import kernels
    from elevation_mapping_cupy_torch.examples import large_world_sharded as lw

    folder, kw = argv[0], lw.parse_worker(argv[1:])
    regs = kernels.registered_kernels()
    for kern in regs.values():
        kern.launches = 0
    with k1_shapes() as shapes:
        lw.worker(**kw)
    with open(os.path.join(folder, f"rank{kw['rank']}.json"), "w") as f:
        json.dump({"launches": {n: k.launches for n, k in regs.items()}, "k1_shapes": sorted(shapes)}, f)


def main(argv) -> int:
    if argv[:1] == ["--example-world-worker"]:
        example_world_worker(argv[1:])
    elif argv[:1] == ["--spatial-worker"] and len(argv) in (5, 7):
        port, rank, size, folder = argv[1:5]
        spatial_worker(int(port), int(rank), int(size), folder, argv[6] if len(argv) == 7 else "gloo")
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
