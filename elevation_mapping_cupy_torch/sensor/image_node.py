"""Semantic image node — camera image → multichannel semantic image.

Equivalent of the reference sidecar's SemanticSegmentationNode
(semantic_sensor/image_node.py:28-205): runs a segmentation / feature
network on an RGB image, emits the per-channel semantic image stack, the
resize-scaled intrinsics, the channel list (ChannelInfo), and a VOC-style
color visualization — everything ``ElevationMap.input_image`` and the
runtime service need from the image path.

No ROS: the node is a plain callable; wire it to ``MappingService`` by
pushing its output as an "image" SensorFrame. The network runs on the
node's device (CUDA unless ``device="cpu"``; without a card that raises).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..mapper import resolve_device
from .networks import resolve_model

__all__ = ["ImageParameter", "SemanticImageNode", "voc_color_map"]


@dataclasses.dataclass
class ImageParameter:
    """Mirrors semantic_sensor ImageParameter (non-ROS parts)."""

    sensor_name: str = "camera"
    channels: Tuple[str, ...] = ("grass", "tree", "person")
    semantic_model: str = "lraspp_mobilenet_v3_large"
    resize: Optional[float] = None        # e.g. 0.5 halves H and W
    show_label_legend: bool = False


def voc_color_map(n: int = 256, normalized: bool = False) -> np.ndarray:
    """Pascal-VOC class colormap (image_node.py:107-134 bit-shuffle)."""

    def bitget(v, idx):
        return (v >> idx) & 1

    dtype = np.float32 if normalized else np.uint8
    cmap = np.zeros((n, 3), dtype)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= bitget(c, 0) << (7 - j)
            g |= bitget(c, 1) << (7 - j)
            b |= bitget(c, 2) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap / 255.0 if normalized else cmap


class SemanticImageNode:
    def __init__(self, param: ImageParameter = None,
                 device: Union[None, str, torch.device] = None, **model_kwargs):
        self.param = param or ImageParameter()
        self.device = resolve_device(device)
        self.model = resolve_model(
            self.param.semantic_model, channels=list(self.param.channels),
            device=self.device, **model_kwargs,
        )
        self.color_map = voc_color_map(max(len(self.param.channels) + 1, 2))

    def scale_intrinsics(self, K: np.ndarray) -> np.ndarray:
        """Resized CameraInfo equivalent (image_node.py:151-166)."""
        K = np.asarray(K, np.float32).copy()
        if self.param.resize is not None:
            K[:2, :] *= self.param.resize
        return K

    def channel_info(self) -> List[str]:
        """ChannelInfo payload: fusion-ready channel names (image_node.py:187)."""
        return [f"sem_{c}" for c in self.param.channels]

    def __call__(
        self, image: np.ndarray, K: Optional[np.ndarray] = None
    ) -> Dict[str, object]:
        """image: (3, H, W) uint8 RGB. Returns dict with:
        ``image`` (C, H', W') float32 channel stack ordered like
        ``channels``, ``channels`` names, ``K`` scaled intrinsics (if given),
        ``label_vis`` (3, H', W') uint8 color map of the argmax class."""
        img = np.asarray(image)
        if self.param.resize is not None:
            c, h, w = img.shape
            nh, nw = int(self.param.resize * h), int(self.param.resize * w)
            ys = (np.arange(nh) * (h / nh)).astype(np.int64)
            xs = (np.arange(nw) * (w / nw)).astype(np.int64)
            img = img[:, ys][:, :, xs]
        pred = self.model.predict(img)
        stack, names = [], []
        for ch in self.param.channels:
            if ch in pred:
                stack.append(np.asarray(pred[ch], np.float32))
                names.append(f"sem_{ch}")
        for extra, v in pred.items():
            if extra not in self.param.channels and extra.startswith("feat"):
                stack.append(np.asarray(v, np.float32))
                names.append(extra)
        arr = np.stack(stack) if stack else np.zeros((0,) + img.shape[1:], np.float32)
        out: Dict[str, object] = {"image": arr, "channels": names}
        if arr.shape[0]:
            # label colors index into param.channels by NAME: only sem_*
            # rows participate (feat_* rows are unbounded features), and a
            # missing channel must not shift its neighbors' colors
            sem_rows = [i for i, nm in enumerate(names) if nm.startswith("sem_")]
            if sem_rows:
                winner = arr[sem_rows].argmax(0)
                chan_idx = np.array(
                    [self.param.channels.index(names[i][4:]) for i in sem_rows]
                )
                label = chan_idx[winner] + 1
            else:
                label = np.zeros(arr.shape[1:], np.int64)
            out["label_vis"] = self.color_map[label % len(self.color_map)].transpose(2, 0, 1)
        if K is not None:
            out["K"] = self.scale_intrinsics(K)
        return out
