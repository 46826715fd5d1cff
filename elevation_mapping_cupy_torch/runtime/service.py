"""Host runtime: sensor ingestion, timers, statistics — the ROS node's job.

Re-expression of ElevationMappingNode (elevation_mapping_ros.cpp) without ROS:
sensor frames arrive through thread-safe queues (or the native frame ring),
a single step loop drains them into the map updates (the AsyncSpinner(1)
serialization becomes explicit), per-publisher fps timers trigger layer
exports, and a Statistics record mirrors the reference's
`pointcloud_process_fps` topic (elevation_mapping_ros.cpp:674-685).

Each step is traced (``tracing``): ``service.spin_once`` holds a
``service.drain`` per frame popped (ring pop, header unpack, native
deinterleave, ``SensorFrame``) and a ``service.fuse`` per frame (its request
id is the frame's stamp); poses are ``service.update_pose``.

Every torch call happens on the thread that calls ``spin_once`` (and the
service calls); producer threads only push host bytes or ``SensorFrame``s.
The map lives on a CUDA device unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import struct
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import tracing
from ..config import MapConfig
from ..mapper import ElevationMap
from . import native

__all__ = [
    "SensorFrame",
    "Publisher",
    "Statistics",
    "MappingService",
    "SubscriberConfig",
    "parse_subscribers",
]


@dataclasses.dataclass
class SensorFrame:
    kind: str                       # "pointcloud" | "image"
    channels: Tuple[str, ...]
    data: np.ndarray                # (N, 3+C) cloud or (C, H, W) image
    R: np.ndarray
    t: np.ndarray
    K: Optional[np.ndarray] = None
    D: Optional[np.ndarray] = None
    distortion_model: str = "radtan"
    stamp: float = 0.0

    @classmethod
    def from_pointcloud2(
        cls,
        data: bytes,
        n_points: int,
        point_step: int,
        offsets: Sequence[int],
        channels: Sequence[str],
        R: np.ndarray,
        t: np.ndarray,
        stamp: float = 0.0,
    ) -> "SensorFrame":
        """Build a pointcloud frame from raw interleaved PointCloud2-style
        bytes — the reference's per-point deinterleave hot loop
        (elevation_mapping_ros.cpp:330-339), run through the native C++
        kernel (runtime/native/pointcloud_native.cc) with non-finite xyz
        rows dropped, exactly like the reference's NaN skip.

        ``offsets`` are the byte offsets of the float32 fields within each
        ``point_step``-byte record, ordered as ``channels`` (x, y, z first).
        """
        mat = native.deinterleave(data, n_points, point_step, offsets)
        return cls(
            kind="pointcloud",
            channels=tuple(channels),
            data=mat,
            R=np.asarray(R, np.float32),
            t=np.asarray(t, np.float32),
            stamp=stamp,
        )


# raw-frame ring header: magic, stamp, n_points, point_step, n_fields,
# 16x field offset, row-major R, t, channel-string length (names follow,
# comma-joined, within the ring's fixed header slot)
_RAW_HDR = "<4sd3i16i9f3fi"
_RAW_HDR_FIXED = struct.calcsize(_RAW_HDR)


@dataclasses.dataclass
class Publisher:
    """One fps-limited layer publisher (the reference's per-publisher
    GridMap timers, elevation_mapping_ros.cpp:234-267).

    ``basic_layers`` is grid_map message METADATA, not a gate: in the
    reference it becomes GridMap::setBasicLayers, and CONSUMERS use it for
    isValid() cell checks — publishing is not filtered by it. Callbacks
    that assemble messages should read it off the Publisher."""

    name: str
    layers: List[str]
    fps: float
    callback: Callable[[Dict[str, np.ndarray]], None]
    last_publish: float = 0.0
    basic_layers: Tuple[str, ...] = ()


@dataclasses.dataclass
class SubscriberConfig:
    """One entry of the reference's `subscribers:` YAML block
    (elevation_mapping_ros.cpp:77-152): a named sensor with a data type and
    its channel list. Pointcloud subscribers always carry x/y/z first; image
    subscribers default to ("rgb",) when no channels are configured."""

    key: str
    data_type: str                       # "pointcloud" | "image"
    topic_name: str = ""
    channels: Tuple[str, ...] = ()
    camera_info_topic_name: str = ""
    channel_info_topic_name: str = ""


def parse_subscribers(block: Dict[str, Dict]) -> Dict[str, SubscriberConfig]:
    """Parse the `subscribers:` extras block (reference YAML schema)."""
    out: Dict[str, SubscriberConfig] = {}
    for key, sc in (block or {}).items():
        dtype = str(sc.get("data_type", ""))
        if dtype not in ("pointcloud", "image"):
            # reference warns and skips unknown data types (:152-154)
            warnings.warn(
                f"subscriber '{key}' data_type '{dtype}' not valid; "
                "supported: pointcloud, image"
            )
            continue
        chans = tuple(str(c) for c in sc.get("channels", ()))
        if dtype == "pointcloud":
            chans = ("x", "y", "z") + tuple(c for c in chans if c not in ("x", "y", "z"))
        elif not chans:
            chans = ("rgb",)
        out[key] = SubscriberConfig(
            key=key,
            data_type=dtype,
            topic_name=str(sc.get("topic_name", "")),
            channels=chans,
            camera_info_topic_name=str(sc.get("camera_info_topic_name", "")),
            channel_info_topic_name=str(sc.get("channel_info_topic_name", "")),
        )
    return out


@dataclasses.dataclass
class Statistics:
    """The service's frame counts and, as the JAX service reports them,
    the host's time to enqueue each frame's map call: the durations of its
    ``service.fuse`` spans, which end when the torch calls are issued, not
    when the card has done them (an enqueue time, not a latency).
    ``last_update_latency`` is the last frame's, in seconds;
    ``pointcloud_process_fps`` is one over the mean of the last 50
    pointcloud frames'."""

    pointcloud_process_fps: float = 0.0
    frames_processed: int = 0
    frames_dropped: int = 0
    last_update_latency: float = 0.0


def _transform_submap(
    layers: Dict[str, np.ndarray],
    xs: np.ndarray,
    ys: np.ndarray,
    height_layer: str,
    R: np.ndarray,
    t: np.ndarray,
    res: float,
) -> Dict[str, np.ndarray]:
    """Transform a map-frame submap into the request frame by forward point
    splat (grid_map::GridMap::getTransformedMap semantics: every valid cell
    becomes a 3D point (x, y, height), is transformed, and lands in the
    nearest cell of a new same-resolution grid covering the transformed
    footprint; non-height layers ride along; unhit cells are NaN)."""
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    h = layers.get(height_layer)
    if h is not None:
        valid = np.isfinite(h).reshape(-1)
        Z = np.where(np.isfinite(h), h, 0.0)
    else:
        valid = np.ones(X.size, bool)
        Z = np.zeros_like(X)
    P = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    Q = P @ R.T + t

    # new grid bounds from the transformed footprint corners (grid_map uses
    # the map corners so the grid exists even when no cell is valid)
    corners = np.array([
        [xs[0], ys[0], 0.0], [xs[0], ys[-1], 0.0],
        [xs[-1], ys[0], 0.0], [xs[-1], ys[-1], 0.0],
    ]) @ R.T + t
    lo = corners[:, :2].min(axis=0) - res / 2
    hi = corners[:, :2].max(axis=0) + res / 2
    nx = max(int(np.ceil((hi[0] - lo[0]) / res)), 1)
    ny = max(int(np.ceil((hi[1] - lo[1]) / res)), 1)

    qi = ((Q[:, 0] - lo[0]) / res).astype(int)
    qj = ((Q[:, 1] - lo[1]) / res).astype(int)
    # drop points outside the new footprint instead of clamping them onto
    # the border (grid_map getTransformedMap skips !isInside points): the
    # bounds come from the z=0 corners, so a pitched/rolled transform can
    # carry tall cells beyond them
    valid = valid & (qi >= 0) & (qi < nx) & (qj >= 0) & (qj < ny)
    qi, qj, Q = qi[valid], qj[valid], Q[valid]

    out: Dict[str, np.ndarray] = {}
    for name, m in layers.items():
        dst = np.full((nx, ny), np.nan, np.float32)
        vals = Q[:, 2] if name == height_layer else m.reshape(-1)[valid]
        dst[qi, qj] = vals
        # match the map-frame export orientation: row 0 / col 0 = max coord
        out[name] = dst[::-1, ::-1].copy()
    return out


class MappingService:
    """Single-threaded step-driven mapping runtime.

    Usage:
        svc = MappingService(cfg)
        svc.enqueue(SensorFrame(...))      # from any thread
        svc.update_pose(position, R)       # pose stream (10 Hz equivalent)
        svc.spin_once()                    # drain queue + run timers
    """

    def __init__(
        self,
        cfg: MapConfig,
        mapper: Optional[ElevationMap] = None,
        queue_size: int = 16,
        pose_alpha: float = 0.1,
        variance_fps: float = 5.0,
        time_fps: float = 10.0,
        device: Union[None, str, torch.device] = None,
    ):
        self.mapper = mapper or ElevationMap(cfg, device=device)
        # Exact-eligible configs: run both routed exact cleanups once now
        # (on the card: K1 and K2 built and loaded) instead of stalling the
        # live mapping loop on the router's first gated->flat flip. No-op
        # for the polar production route.
        self.mapper.warm_raycast_impls()
        self.queue: "queue.Queue[SensorFrame]" = queue.Queue(maxsize=queue_size)
        self.publishers: List[Publisher] = []
        self.stats = Statistics()
        self._alive_cbs: List[Callable[[], None]] = []
        self._pose_alpha = pose_alpha
        self._lowpass_position = np.zeros(3)
        self._lowpass_orientation = np.eye(3)
        self._position_noise = 0.0
        self._orientation_noise = 0.0
        self._variance_period = 1.0 / variance_fps if variance_fps > 0 else None
        self._time_period = 1.0 / time_fps if time_fps > 0 else None
        self._last_variance = 0.0
        self._last_time = 0.0
        # the last 50 pointcloud frames' service.fuse durations, in seconds
        self._proc_times: "collections.deque[float]" = collections.deque(maxlen=50)
        self.publish_points_enabled = False
        # optional callable returning (N, 3) world points for
        # clear_map_with_initializer (reference: TF frame positions)
        self.initialize_points_provider: Optional[Callable[[], np.ndarray]] = None
        # named sensors from the config's `subscribers:` block
        self.subscribers: Dict[str, SubscriberConfig] = {}
        # optional zero-copy raw ingest ring (enable_raw_ingest)
        self._ring = None

    @classmethod
    def from_config(cls, yaml_path: str, **kw) -> "MappingService":
        """Build a service from a reference-style core_param.yaml (needs
        PyYAML): MapConfig fields drive the engine; the ROS-layer extras
        wire the runtime (subscribers, publishers, fps timers, lowpass
        alpha) the way ElevationMappingNode::ElevationMappingNode does
        (elevation_mapping_ros.cpp:50-228). ``device`` and the other
        keywords go to the constructor."""
        from ..config import load_config_with_extras

        cfg, extras = load_config_with_extras(yaml_path)
        return cls.from_settings(cfg, extras, **kw)

    @classmethod
    def from_settings(cls, cfg: MapConfig, extras: Dict[str, Any], **kw) -> "MappingService":
        """``from_config`` on a config and extras already loaded (the pair
        ``load_config_with_extras`` returns)."""
        kw.setdefault("variance_fps", float(extras.get("update_variance_fps", 5.0)))
        # time_interval is both an engine param and the node's updateTime
        # timer period (elevation_mapping_ros.cpp:62, parameter.py)
        if cfg.time_interval > 0:
            kw.setdefault("time_fps", 1.0 / cfg.time_interval)
        kw.setdefault("pose_alpha", float(extras.get("position_lowpass_alpha", 0.1)))
        svc = cls(cfg, **kw)
        svc.subscribers = parse_subscribers(extras.get("subscribers", {}))
        for name, spec in (extras.get("publishers") or {}).items():
            svc.publishers.append(Publisher(
                name=name,
                layers=list(spec.get("layers", [])),
                fps=float(spec.get("fps", 1.0)),
                callback=lambda _out: None,   # replace via set_publisher_callback
                basic_layers=tuple(spec.get("basic_layers", ())),
            ))
        svc.publish_points_enabled = bool(
            extras.get("enable_pointcloud_publishing", False)
        )
        return svc

    def set_publisher_callback(
        self, name: str, callback: Callable[[Dict[str, np.ndarray]], None]
    ) -> None:
        for pub in self.publishers:
            if pub.name == name:
                pub.callback = callback
                return
        raise KeyError(name)

    # ---------------------------------------------------------------- inputs
    def enqueue(self, frame: SensorFrame, subscriber: Optional[str] = None) -> bool:
        """Non-blocking enqueue; drops the frame when the queue is full (the
        reference's subscriber queue_size=1 behavior).

        ``subscriber`` names an entry of the config's `subscribers:` block:
        the frame's kind is checked against the configured data_type and
        empty channels are filled from the subscriber's channel list (the
        reference's channels_[key] wiring, elevation_mapping_ros.cpp:84-140).
        """
        if subscriber is not None:
            sc = self.subscribers.get(subscriber)
            if sc is None or sc.data_type != frame.kind:
                self.stats.frames_dropped += 1
                return False
            if not frame.channels:
                frame = dataclasses.replace(frame, channels=sc.channels)
        try:
            self.queue.put_nowait(frame)
            return True
        except queue.Full:
            self.stats.frames_dropped += 1
            return False

    def enable_raw_ingest(
        self,
        capacity: int = 16,
        slab_bytes: int = 8 << 20,
        drop_oldest: bool = False,
        header_bytes: int = 256,
    ) -> None:
        """Route raw sensor bytes through the native bounded frame ring
        (runtime/native/frame_ring.cc): producer threads memcpy the
        interleaved record block into a preallocated slab (no Python-object
        churn, ROS queue_size drop semantics), and the single consumer
        (spin_once) runs the native deinterleave hot loop at drain time —
        the reference's PointCloud2→Eigen conversion
        (elevation_mapping_ros.cpp:330-339) moved off the producer thread."""
        self._ring = native.FrameRing(
            capacity=capacity, slab_bytes=slab_bytes,
            header_bytes=header_bytes, drop_oldest=drop_oldest,
        )

    def enqueue_raw_pointcloud(
        self,
        data: bytes,
        n_points: int,
        point_step: int,
        offsets: Sequence[int],
        channels: Sequence[str],
        R: np.ndarray,
        t: np.ndarray,
        stamp: float = 0.0,
        subscriber: Optional[str] = None,
    ) -> bool:
        """Non-blocking raw-bytes enqueue into the native ring (requires
        enable_raw_ingest); safe from any thread. The payload is the
        interleaved record block as it arrives from the sensor transport;
        deinterleaving happens in spin_once via the native code."""
        if self._ring is None:
            raise RuntimeError("call enable_raw_ingest() first")
        if subscriber is not None:
            sc = self.subscribers.get(subscriber)
            if sc is None or sc.data_type != "pointcloud":
                self.stats.frames_dropped += 1
                return False
            if not channels:
                channels = sc.channels
        offs = list(offsets) + [0] * (16 - len(offsets))
        names = ",".join(channels).encode()
        header = struct.pack(
            _RAW_HDR, b"PC2\0", float(stamp), int(n_points), int(point_step),
            len(offsets), *offs,
            *np.asarray(R, np.float32).reshape(9),
            *np.asarray(t, np.float32).reshape(3),
            len(names),
        ) + names
        if len(header) > self._ring.header_bytes:
            raise ValueError(
                f"channel names too long for {self._ring.header_bytes}-byte header"
            )
        payload = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) else np.ascontiguousarray(data, np.uint8)
        ok = self._ring.push(header, payload)
        if not ok:
            self.stats.frames_dropped += 1
        return ok

    def _pop_raw_frame(self) -> Optional[SensorFrame]:
        item = self._ring.pop() if self._ring is not None else None
        if item is None:
            return None
        header, payload = item
        fixed = struct.unpack(_RAW_HDR, header[:_RAW_HDR_FIXED])
        magic, stamp, n_points, point_step, n_fields = fixed[0], fixed[1], fixed[2], fixed[3], fixed[4]
        if magic != b"PC2\0":
            self.stats.frames_dropped += 1
            return None
        offs = fixed[5 : 5 + n_fields]
        R = np.asarray(fixed[21:30], np.float32).reshape(3, 3)
        t = np.asarray(fixed[30:33], np.float32)
        name_len = fixed[33]
        channels = header[_RAW_HDR_FIXED : _RAW_HDR_FIXED + name_len].decode().split(",")
        return SensorFrame.from_pointcloud2(
            payload, n_points, point_step, offs, channels, R, t, stamp
        )

    def update_pose(self, position: np.ndarray, R: np.ndarray) -> None:
        """Pose stream: lowpass → position/orientation noise for the drift
        gate (elevation_mapping_ros.cpp:480-492), then recenter the map."""
        with tracing.span("service.update_pose"):
            position = np.asarray(position, np.float64)
            R = np.asarray(R, np.float64)
            self._lowpass_position = (
                (1 - self._pose_alpha) * self._lowpass_position + self._pose_alpha * position
            )
            self._lowpass_orientation = (
                (1 - self._pose_alpha) * self._lowpass_orientation + self._pose_alpha * R
            )
            self._position_noise = float(np.linalg.norm(position - self._lowpass_position))
            self._orientation_noise = float(
                np.linalg.norm(R - self._lowpass_orientation)
            )
            self.mapper.move_to(position, R)

    # --------------------------------------------------------------- outputs
    def add_publisher(
        self, name: str, layers: Sequence[str], fps: float,
        callback: Callable[[Dict[str, np.ndarray]], None],
    ) -> None:
        self.publishers.append(Publisher(name, list(layers), fps, callback))

    def on_alive(self, cb: Callable[[], None]) -> None:
        self._alive_cbs.append(cb)

    # ------------------------------------------------------------------ spin
    def spin_once(self, now: Optional[float] = None) -> int:
        """Drain the sensor queue, run due timers/publishers. Returns the
        number of frames processed."""
        now = time.monotonic() if now is None else now
        with tracing.span("service.spin_once"):
            processed = self._drain_and_fuse()
            if self._variance_period and now - self._last_variance >= self._variance_period:
                self.mapper.update_variance()
                self._last_variance = now
            if self._time_period and now - self._last_time >= self._time_period:
                self.mapper.update_time()
                self._last_time = now
            for pub in self.publishers:
                if pub.fps > 0 and now - pub.last_publish >= 1.0 / pub.fps:
                    # one export call and one read-back for the whole layer set
                    out = self.mapper.get_layers(
                        [l for l in pub.layers if self.mapper.exists_layer(l)]
                    )
                    pub.callback(out)
                    pub.last_publish = now
        return processed

    def _next_frame(self) -> Optional[SensorFrame]:
        """The next frame: the raw ring first (native deinterleave at drain
        time), then the regular SensorFrame queue; None when both are empty."""
        with tracing.span("service.drain") as drain:
            frame = self._pop_raw_frame()
            if frame is None:
                try:
                    frame = self.queue.get_nowait()
                except queue.Empty:
                    return None
            drain.rid = frame.stamp
            return frame

    def _drain_and_fuse(self) -> int:
        processed = 0
        while True:
            frame = self._next_frame()
            if frame is None:
                break
            if frame.kind not in ("pointcloud", "image"):
                self.stats.frames_dropped += 1
                continue
            with tracing.span("service.fuse", rid=frame.stamp) as fuse:
                if frame.kind == "pointcloud":
                    self.mapper.input_pointcloud(
                        frame.data, list(frame.channels), frame.R, frame.t,
                        self._position_noise, self._orientation_noise,
                    )
                else:
                    self.mapper.input_image(
                        frame.data, list(frame.channels), frame.R, frame.t,
                        frame.K, frame.D, frame.distortion_model,
                    )
            if frame.kind == "pointcloud":
                # the reference's fps statistic counts pointcloud callbacks
                # only (pointCloudProcessCounter_, elevation_mapping_ros.cpp:316)
                self._proc_times.append(fuse.ms / 1e3)
            self.stats.last_update_latency = fuse.ms / 1e3
            self.stats.frames_processed += 1
            processed += 1
            for cb in self._alive_cbs:
                cb()
        if self._proc_times:
            self.stats.pointcloud_process_fps = 1.0 / float(np.mean(self._proc_times))
        return processed

    # -------------------------------------------------------------- services
    def get_submap(
        self,
        center_xy: np.ndarray,
        length_xy: Tuple[float, float],
        layers: Sequence[str],
        frame_transform: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        height_layer: str = "elevation",
    ) -> Dict[str, np.ndarray]:
        """get_raw_submap service equivalent (elevation_mapping_ros.cpp:507-553).

        ``frame_transform`` is the request-frame handling: (R, t) mapping
        MAP-frame points into the REQUEST frame — the reference's
        lookupTransform(requestedFrameId, mapFrameId) result. When given,
        ``center_xy`` is interpreted in the request frame (transformed into
        the map frame with the inverse, :521-526), the axis-aligned submap is
        extracted in the map frame, and the result is transformed into the
        request frame grid_map::getTransformedMap-style (forward point splat
        of each valid cell's (x, y, height) with non-height layers carried
        along, :539-541).
        """
        res = self.mapper.resolution
        n = self.mapper.cell_n - 2
        c = np.asarray(self.mapper.center[:2])
        center_xy = np.asarray(center_xy, np.float64)
        if frame_transform is not None:
            Rf = np.asarray(frame_transform[0], np.float64)
            tf = np.asarray(frame_transform[1], np.float64)
            p = np.array([center_xy[0], center_xy[1], 0.0])
            center_xy = (Rf.T @ (p - tf))[:2]
        full = np.zeros((n, n), np.float32)
        half = np.array(length_xy) / 2
        lo = np.clip(((center_xy - half - (c - n * res / 2)) / res).astype(int), 0, n)
        hi = np.clip(((center_xy + half - (c - n * res / 2)) / res).astype(int), 0, n)
        out = {}
        for layer in layers:
            if not self.mapper.exists_layer(layer):
                continue
            self.mapper.get_map_with_name_ref(layer, full)
            # the export is double-flipped (internal row i -> exported row
            # n-1-i, see get_map_pointcloud); convert the world-frame index
            # window into exported coordinates before slicing
            out[layer] = full[n - hi[0] : n - lo[0], n - hi[1] : n - lo[1]].copy()
        if frame_transform is None or not out:
            return out
        # world (map-frame) coordinates of the extracted window: output row k
        # corresponds to internal row hi[0]-1-k (see flip note above)
        xs = c[0] + (hi[0] - 1 - np.arange(hi[0] - lo[0]) - n / 2.0 + 0.5) * res
        ys = c[1] + (hi[1] - 1 - np.arange(hi[1] - lo[1]) - n / 2.0 + 0.5) * res
        return _transform_submap(out, xs, ys, height_layer, Rf, tf, res)

    def clear_map(self) -> None:
        self.mapper.clear()

    def initialize(self, points: np.ndarray, method: str = "cubic") -> None:
        self.mapper.initialize_map(points, method)

    def clear_map_with_initializer(
        self, method: str = "cubic", tf_grid_size: float = 0.5
    ) -> None:
        """clear_map_with_initializer service (elevation_mapping_ros.cpp:564-569):
        clear, then re-initialize from the configured point provider (the
        reference reads TF frames, e.g. foot positions — here any callable
        set via ``initialize_points_provider``). Fewer than 3 points are
        expanded to a tf_grid_size square around the last one
        (initializeWithTF, elevation_mapping_ros.cpp:593-598)."""
        self.mapper.clear()
        if self.initialize_points_provider is None:
            return
        pts = np.asarray(self.initialize_points_provider(), np.float64).reshape(-1, 3)
        if len(pts) == 0:
            return
        if len(pts) < 3:
            g = tf_grid_size
            p = pts[-1]
            pts = np.vstack(
                [pts, p + np.array([[g, g, 0], [-g, g, 0], [g, -g, 0], [-g, -g, 0]])]
            )
        try:
            self.mapper.initialize_map(pts, method)
        except ValueError:
            # exactly 3 provider points on a just-cleared map: griddata needs
            # >3 support points (the reference asserts and crashes the
            # embedded call here, map_initializer.py:43 — we drop the frame
            # like its tf-error handling does elsewhere)
            self.stats.frames_dropped += 1

    def set_publish_points(self, enable: bool) -> bool:
        """set_publish_points service (elevation_mapping_ros.cpp:660-664)."""
        self.publish_points_enabled = bool(enable)
        return True

    def get_map_pointcloud(self) -> np.ndarray:
        """Map as an (N, 3) debug pointcloud (publishPoints equivalent,
        elevation_mapping_ros.cpp:501-505); empty unless enabled."""
        if not self.publish_points_enabled:
            return np.zeros((0, 3), np.float32)
        n = self.mapper.cell_n - 2
        elev = np.zeros((n, n), np.float32)
        self.mapper.get_map_with_name_ref("elevation", elev)
        res = self.mapper.resolution
        c = np.asarray(self.mapper.center)
        ys, xs = np.mgrid[0:n, 0:n]
        # undo the export double-flip to map cells back to world axes
        world_x = c[0] + ((n - 1 - ys) - n / 2.0 + 0.5) * res
        world_y = c[1] + ((n - 1 - xs) - n / 2.0 + 0.5) * res
        ok = np.isfinite(elev)
        return np.stack([world_x[ok], world_y[ok], elev[ok]], axis=1).astype(np.float32)

    def map_to_odom_error(self) -> float:
        """Accumulated drift estimate for the corrected map→odom TF
        (publishMapToOdom, elevation_mapping_ros.cpp:365,811-818)."""
        return self.mapper.get_additive_mean_error()

    def check_safety(self, polygons: Sequence[np.ndarray]):
        """CheckSafety service equivalent: per polygon → (is_safe,
        traversability, untraversable polygon)."""
        results = []
        for poly in polygons:
            res = np.zeros(3)
            n = self.mapper.get_polygon_traversability(np.asarray(poly, np.float32), res)
            un = np.zeros((n, 2))
            if n:
                self.mapper.get_untraversable_polygon(un)
            results.append((bool(res[0]), float(res[1]), un))
        return results
