"""Typed, hashable configuration for the PyTorch elevation mapping engine.

A copy of ``elevation_mapping_cupy_tpu/config.py`` (the port keeps its own so
it never imports the JAX package). Analogue of the reference's ``Parameter``
dataclass (elevation_mapping_cupy/script/elevation_mapping_cupy/parameter.py:
137-226): a frozen dataclass whose fields fix every shape of the update, so
the same config object drives both packages and compares equal across them.

All tunables keep the reference's names and defaults so YAML configs written
for the reference (config/core/core_param.yaml) can be loaded unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

__all__ = [
    "MapConfig",
    "load_config",
    "load_config_with_extras",
    "ROS_ONLY_KEYS",
    "KEY_ALIASES",
    "DEFAULT_CORE_LAYERS",
]

# Core layer order  (reference: elevation_mapping.py:69-77)
DEFAULT_CORE_LAYERS: Tuple[str, ...] = (
    "elevation",
    "variance",
    "is_valid",
    "traversability",
    "time",
    "upper_bound",
    "is_upper_bound",
)

# indices into the core layer stack
ELEVATION, VARIANCE, IS_VALID, TRAVERSABILITY, TIME, UPPER_BOUND, IS_UPPER_BOUND = range(7)


@dataclass(frozen=True)
class MapConfig:
    """Frozen (hashable) parameter tree.

    Defaults mirror the reference ``Parameter`` dataclass one-to-one
    (parameter.py:137-226).
    """

    # --- geometry ---
    resolution: float = 0.04           # cell size [m]
    map_length: float = 8.0            # map side length [m]

    # --- sensor / fusion ---
    sensor_noise_factor: float = 0.05  # noise = factor * z_sensor^2
    mahalanobis_thresh: float = 2.0
    outlier_variance: float = 0.01
    drift_compensation_variance_inlier: float = 0.1
    time_variance: float = 0.01
    time_interval: float = 0.1
    max_variance: float = 1.0
    initial_variance: float = 10.0
    initialized_variance: float = 10.0

    # --- filters ---
    dilation_size: int = 2
    dilation_size_initialize: int = 10
    wall_num_thresh: float = 100.0
    min_filter_size: int = 5
    min_filter_iteration: int = 3

    # --- drift compensation ---
    enable_drift_compensation: bool = True
    max_drift: float = 0.10
    drift_compensation_alpha: float = 1.0
    traversability_inlier: float = 0.1
    min_height_drift_cnt: float = 100.0
    position_noise_thresh: float = 0.1
    orientation_noise_thresh: float = 0.1

    # --- visibility cleanup / raycast ---
    enable_visibility_cleanup: bool = True
    max_ray_length: float = 2.0
    cleanup_step: float = 0.01
    cleanup_cos_thresh: float = 0.5
    # raycast backend: "polar" = shadow-cube formulation (one point->bin
    # scatter, tolerance-level approximation at bucket boundaries); "exact" =
    # per-step march matching the reference semantics (not ported yet);
    # "auto" = exact only for short marches whose work is well below the
    # cube's (see ops/raycast.py::resolve_raycast_mode), polar otherwise.
    raycast_mode: str = "auto"
    # 0 = auto: next power of two >= 12*cell_n, capped at 512 (= 512 at the
    # reference's 202-cell scale; small maps get a proportionally small
    # shadow cube instead of a 512-wide one)
    raycast_azimuth_bins: int = 0
    raycast_elevation_bins: int = 128
    # azimuth min-pyramid depth (memory knob: each level costs an (A, R, S)
    # tensor)
    raycast_pyramid_levels: int = 6
    # upper-bound slope source: True = bucket-center slope (skips the
    # scatter-min + min-pyramid; quantization = half an elevation bucket);
    # False = exact per-bucket scatter-min
    raycast_slope_from_bins: bool = True
    # exact-march implementation ("scan" | "flat" | "gated" | "auto") and the
    # flat march's sample-chunk size. Kept so configs compare equal across
    # the two packages; read only by the exact march, which the port does
    # not have yet.
    raycast_exact_impl: str = "auto"
    raycast_flat_chunk: int = 1 << 22

    # --- validity ramp ---
    min_valid_distance: float = 0.3
    max_height_range: float = 1.0
    ramped_height_range_a: float = 0.3
    ramped_height_range_b: float = 1.0
    ramped_height_range_c: float = 0.2

    # --- edge sharpen / overlap ---
    enable_edge_sharpen: bool = True
    enable_overlap_clearance: bool = True
    overlap_clear_range_xy: float = 4.0
    overlap_clear_range_z: float = 2.0

    # --- polygon safety ---
    safe_thresh: float = 0.5
    safe_min_thresh: float = 0.5
    max_unsafe_n: int = 20
    checker_layer: str = "traversability"

    # --- upper bound export ---
    use_only_above_for_upper_bound: bool = True

    # --- semantic (MEM) layers: static at trace time ---
    # names of additional semantic layers, and per-layer fusion algorithm.
    semantic_layers: Tuple[str, ...] = ()
    # mapping channel-name-pattern -> fusion algo, evaluated like the
    # reference's pointcloud_channel_fusions / image_channel_fusions
    # (parameter.py:160-161), flattened to tuples to stay hashable.
    pointcloud_channel_fusions: Tuple[Tuple[str, str], ...] = (
        ("rgb", "color"),
        ("default", "class_average"),
    )
    image_channel_fusions: Tuple[Tuple[str, str], ...] = (
        ("rgb", "color"),
        ("default", "exponential"),
    )
    average_weight: float = 0.5        # EMA alpha for class_average fusion
    image_exponential_alpha: float = 0.7

    # --- image path ---
    tolerance_z_collision: float = 0.10
    # occlusion backend: "shadow" = camera-centric polar shadow map (one
    # scatter + prefix scan); "bresenham" = per-cell
    # height-map march matching the reference kernel step-for-step
    image_occlusion_mode: str = "shadow"
    image_occlusion_azimuth_bins: int = 1024

    # --- runtime / batching ---
    max_points: int = 131072           # static pointcloud padding size
    data_type: str = "float32"

    # ------------------------------------------------------------------
    @property
    def cell_n(self) -> int:
        """Number of cells per side incl. 1-cell border (parameter.py:287)."""
        return int(round(self.map_length / self.resolution)) + 2

    @property
    def true_cell_n(self) -> int:
        return int(round(self.map_length / self.resolution))

    @property
    def true_map_length(self) -> float:
        return self.true_cell_n * self.resolution

    @property
    def ray_step(self) -> float:
        """Raycast step (reference: custom_kernels.py:268 ray_step=res/sqrt(2))."""
        return self.resolution / math.sqrt(2.0)

    @property
    def n_ray_steps(self) -> int:
        """Static number of raycast steps: s = step, 2*step, ... < max_ray_length."""
        return max(int(math.ceil(self.max_ray_length / self.ray_step)) - 1, 0)

    @property
    def azimuth_bins(self) -> int:
        """Effective polar-raycast azimuth bin count (auto when the config
        field is 0: next pow2 >= 12*cell_n, capped at 512).

        The 12x multiplier is the saturation point of the polar-vs-exact
        trajectory divergence (PARITY.md: validity-flip count and trav p99
        stop improving above ~12 bins per cell of map width). Maps with
        cell_n >= ~43 hit the 512 cap, the JAX package's choice at the
        deployed 202-cell scale; the port keeps it so both packages build
        the same cube.
        """
        if self.raycast_azimuth_bins > 0:
            return self.raycast_azimuth_bins
        return min(512, 1 << max(12 * self.cell_n - 1, 1).bit_length())

    @property
    def overlap_cell_range(self) -> Tuple[int, int]:
        """(cell_min, cell_max) for overlap clearance (elevation_mapping.py:88-91)."""
        cell_range = int(self.overlap_clear_range_xy / self.resolution)
        cell_range = max(0, min(cell_range, self.cell_n))
        return (
            self.cell_n // 2 - cell_range // 2,
            self.cell_n // 2 + cell_range // 2,
        )

    # ------------------------------------------------------------------
    def replace(self, **kw: Any) -> "MapConfig":
        return dataclasses.replace(self, **kw)

    def fusion_for_channel(self, channel: str, kind: str = "pointcloud") -> Optional[str]:
        """Resolve a channel name to a fusion algorithm.

        Mirrors SemanticMap.get_fusion / get_matching_fusion semantics
        (semantic_map.py:141-182): exact regex match wins, else 'default'.
        """
        import re

        table = (
            self.pointcloud_channel_fusions
            if kind == "pointcloud"
            else self.image_channel_fusions
        )
        default = None
        for pat, alg in table:
            if pat == "default":
                default = alg
                continue
            if re.match(f"^{pat}$", channel):
                return alg
        return default


# Keys that exist only in the reference's ROS layer (node wiring, frames,
# timers, initializer service, traversability-backend choice) — they are
# meaningful configuration, just not MapConfig fields. load_config collects
# them into the extras dict without warning; the runtime service consumes
# the relevant ones (elevation_mapping_ros.cpp:77-228, core_param.yaml).
ROS_ONLY_KEYS = frozenset(
    {
        "map_frame",
        "base_frame",
        "corrected_map_frame",
        "update_variance_fps",
        "update_pose_fps",
        "map_acquire_fps",
        "publish_statistics_fps",
        "position_lowpass_alpha",
        "orientation_lowpass_alpha",
        "enable_pointcloud_publishing",
        "enable_drift_corrected_TF_publishing",
        "enable_normal_color",
        "use_chainer",
        "weight_file",
        "initialize_method",
        "initialize_frame_id",
        "initialize_tf_offset",
        "initialize_tf_grid_size",
        "use_initializer_at_start",
        "plugin_config_file",
        "subscribers",
        "publishers",
    }
)

# The reference's shipped core_param.yaml misspells this key
# (core_param.yaml:7). NOTE the reference's own C++ bridge mirrors params BY
# DATACLASS FIELD NAME (wrapper.cpp:45-77), so the misspelled key is never
# read there and the robot runs with the dataclass default — we honor the
# yaml's INTENT instead and say so with a warning.
KEY_ALIASES = {
    "drift_compensation_variance_inler": "drift_compensation_variance_inlier",
}


def load_config_with_extras(
    yaml_path: str, **overrides: Any
) -> Tuple[MapConfig, Dict[str, Any]]:
    """Load a reference-style core_param.yaml.

    Returns (config, extras) where extras carries the ROS-layer keys
    (frames, fps timers, initializer, subscribers/publishers blocks) for the
    runtime service. Unknown keys that are neither MapConfig fields nor
    known ROS keys raise a UserWarning instead of being silently dropped
    (a typo'd tunable must not degrade parity without a signal)."""
    import warnings

    import yaml

    with open(yaml_path, "r") as f:
        raw: Mapping[str, Any] = yaml.safe_load(f) or {}
    known = {f.name for f in dataclasses.fields(MapConfig)}
    kw: Dict[str, Any] = {}
    extras: Dict[str, Any] = {}
    for k, v in raw.items():
        if k in KEY_ALIASES:
            warnings.warn(
                f"config key '{k}' is the reference yaml's misspelling of "
                f"'{KEY_ALIASES[k]}'; applying it to the correct field "
                "(the reference C++ bridge silently drops it)",
                stacklevel=2,
            )
            k = KEY_ALIASES[k]
        if k in known:
            kw[k] = v
        elif k in ROS_ONLY_KEYS:
            extras[k] = v
        else:
            warnings.warn(
                f"unknown config key '{k}' ignored (not a MapConfig field "
                "or a known ROS-layer key — check for typos)",
                stacklevel=2,
            )
    for name in ("pointcloud_channel_fusions", "image_channel_fusions"):
        if name in kw and isinstance(kw[name], dict):
            kw[name] = tuple(sorted(kw[name].items()))
    if "semantic_layers" in kw and isinstance(kw["semantic_layers"], list):
        kw["semantic_layers"] = tuple(kw["semantic_layers"])
    kw.update(overrides)
    return MapConfig(**kw), extras


def load_config(yaml_path: str, **overrides: Any) -> MapConfig:
    """Load a reference-style core_param.yaml into a MapConfig (see
    load_config_with_extras for the ROS-layer keys)."""
    return load_config_with_extras(yaml_path, **overrides)[0]
