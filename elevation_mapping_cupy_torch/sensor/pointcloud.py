"""Depth-image → structured semantic pointcloud (PointcloudNode equivalent).

Re-derivation of the reference sensor sidecar's pinhole back-projection
(semantic_sensor/pointcloud_node.py:205-250): depth (+rgb, +confidence,
+semantic channels) become an (N, 3 + C) cloud ready for
ElevationMap.input_pointcloud. The back-projection runs on the host; the
semantic network runs on the node's device (CUDA unless ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..mapper import resolve_device

__all__ = ["PointcloudParameter", "create_pcl_from_image", "PointcloudSensorNode"]


@dataclasses.dataclass
class PointcloudParameter:
    """Mirrors semantic_sensor/pointcloud_parameters.py:5-47 (non-ROS parts)."""

    sensor_name: str = "camera"
    channels: Tuple[str, ...] = ()
    fusion: Tuple[str, ...] = ()
    confidence: bool = False
    confidence_threshold: float = 10.0
    depth_scale: float = 1.0


def create_pcl_from_image(
    depth: np.ndarray,              # (H, W) depth [m]; 0/NaN = invalid
    K: np.ndarray,                  # (3, 3) intrinsics
    channels: Dict[str, np.ndarray] = None,   # name -> (H, W) per-pixel values
    rgb: Optional[np.ndarray] = None,          # (3, H, W) uint8
    confidence: Optional[np.ndarray] = None,   # (H, W)
    confidence_threshold: float = 10.0,
    stride: int = 1,
) -> Tuple[np.ndarray, List[str]]:
    """Returns (cloud (N, 3+C) float32 in the camera frame, channel names).

    Camera convention: x right, y down, z forward (optical frame), like the
    reference's cv-style back-projection.
    """
    channels = channels or {}
    H, W = depth.shape
    v, u = np.mgrid[0:H:stride, 0:W:stride]
    z = depth[::stride, ::stride].astype(np.float32)
    valid = np.isfinite(z) & (z > 0)
    if confidence is not None:
        valid &= confidence[::stride, ::stride] >= confidence_threshold
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy

    cols = [x[valid], y[valid], z[valid]]
    names = ["x", "y", "z"]
    if rgb is not None:
        r = rgb[0, ::stride, ::stride][valid].astype(np.uint32)
        g = rgb[1, ::stride, ::stride][valid].astype(np.uint32)
        b = rgb[2, ::stride, ::stride][valid].astype(np.uint32)
        cols.append(((r << 16) | (g << 8) | b).view(np.float32))
        names.append("rgb")
    for name, img in channels.items():
        cols.append(img[::stride, ::stride][valid].astype(np.float32))
        names.append(name)
    cloud = np.stack(cols, axis=1).astype(np.float32)
    return cloud, names


class PointcloudSensorNode:
    """Full sidecar node: depth(+rgb, +confidence) frame → semantic network →
    structured (N, 3+C) cloud + channel names + debug visualizations.

    The non-ROS re-expression of semantic_sensor/pointcloud_node.py:23-365:
    the subscriber/publisher soup becomes one __call__ per synchronized
    frame; the result feeds ElevationMap.input_pointcloud or a
    runtime.service SensorFrame directly. The network runs on ``device``
    (CUDA unless the caller passes ``device="cpu"``; without a card that
    raises).
    """

    def __init__(self, param: PointcloudParameter = PointcloudParameter(),
                 semantic_model: Optional[str] = None,
                 device: Union[None, str, torch.device] = None, **model_kw):
        self.param = param
        self.device = resolve_device(device)
        self.model = None
        if semantic_model is not None:
            from .networks import resolve_model

            self.model = resolve_model(
                semantic_model, channels=list(param.channels) or None, device=self.device, **model_kw
            )

    def channel_info(self) -> List[str]:
        """ChannelInfo message equivalent: names after x,y,z(,rgb)."""
        names = []
        if self.param.channels:
            names.extend(self.param.channels)
        return names

    def __call__(
        self,
        depth: np.ndarray,                       # (H, W) [m]
        K: np.ndarray,                           # (3, 3)
        rgb: Optional[np.ndarray] = None,        # (3, H, W) uint8
        confidence: Optional[np.ndarray] = None,  # (H, W)
        stride: int = 1,
    ) -> Tuple[np.ndarray, List[str]]:
        """Process one synchronized frame; returns (cloud, channel names)."""
        sem: Dict[str, np.ndarray] = {}
        if self.model is not None and rgb is not None:
            pred = self.model.predict(rgb)
            wanted = self.param.channels or tuple(pred.keys())
            for name in wanted:
                if name in pred:
                    sem[name] = np.asarray(pred[name], np.float32)
        depth = depth * self.param.depth_scale
        return create_pcl_from_image(
            depth, K, channels=sem, rgb=rgb,
            confidence=confidence if self.param.confidence else None,
            confidence_threshold=self.param.confidence_threshold,
            stride=stride,
        )
