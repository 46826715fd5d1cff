"""Built-in post-processing plugins.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/plugins/builtin.py``,
the reference plugin set (plugins/*.py) as eager tensor ops on the map's
device, and host-side cv2/NumPy where the reference deliberately ran on the
CPU (inpainting, erosion):

  min_filter / max_filter     plugins/min_filter.py:29-118, max_filter.py:36-113
  smooth_filter               plugins/smooth_filter.py:48-59
  inpainting                  plugins/inpainting.py:53-61 (cv2, host)
  erosion                     plugins/erosion.py:41-113 (cv2, host)
  semantic_filter             plugins/semantic_filter.py:92-133
  semantic_traversability     plugins/semantic_traversability.py:36-81
  max_layer_filter            plugins/max_layer_filter.py:44-108
  robot_centric_elevation     plugins/robot_centric_elevation.py:30-121
  features_pca                plugins/features_pca.py:42-96

Inpainting and erosion run cv2 where it is installed; without it, inpainting
diffuses neighbour means on the map's device and erosion takes a NumPy
minimum over the window, as the JAX package does.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..ops import stencil
from ..semantic.fusions import uint_to_rgb_float
from .manager import PluginBase

__all__ = ["REGISTRY", "cv2_available"]


def _cv2():
    """The cv2 module, or None where it is not installed."""
    try:
        import cv2 as cv
    except ImportError:
        return None
    return cv


def cv2_available() -> bool:
    """Whether the inpainting and erosion plugins take their cv2 branch."""
    return _cv2() is not None


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float32).numpy()


class MinFilter(PluginBase):
    def __init__(self, cell_n: int = 100, dilation_size: int = 5, iteration_n: int = 5, **kw):
        self.size = int(dilation_size)
        self.iters = int(iteration_n)

    def __call__(self, elevation_map, layer_names, *args):
        return stencil.min_filter(elevation_map[0], elevation_map[2], self.size, self.iters)


class MaxFilter(PluginBase):
    def __init__(self, cell_n: int = 100, dilation_size: int = 5, iteration_n: int = 5, **kw):
        self.size = int(dilation_size)
        self.iters = int(iteration_n)

    def __call__(self, elevation_map, layer_names, *args):
        return stencil.max_filter(elevation_map[0], elevation_map[2], self.size, self.iters)


class SmoothFilter(PluginBase):
    def __init__(self, cell_n: int = 100, input_layer_name: str = "elevation", **kw):
        self.input_layer_name = input_layer_name

    def __call__(self, elevation_map, layer_names, plugin_layers, plugin_layer_names, *args):
        if self.input_layer_name in layer_names:
            h = elevation_map[layer_names.index(self.input_layer_name)]
        elif self.input_layer_name in plugin_layer_names:
            h = plugin_layers[plugin_layer_names.index(self.input_layer_name)]
        else:
            h = elevation_map[0]
        return stencil.uniform_smooth(h, passes=2, size=3)


class Inpainting(PluginBase):
    """cv2.inpaint on the normalized-uint8 height image (host-side, like the
    reference). Without cv2, 32 rounds of neighbour-mean diffusion on the
    map's device."""

    def __init__(self, cell_n: int = 100, method: str = "telea", **kw):
        self.method = method

    def __call__(self, elevation_map, layer_names, *args):
        invalid = elevation_map[2] < 0.5
        if bool(invalid.all()):  # no known height to inpaint from
            return elevation_map[0]
        cv = _cv2()
        if cv is not None:
            h = _host(elevation_map[0])
            mask = invalid.cpu().numpy().astype(np.uint8)
            flag = cv.INPAINT_NS if self.method == "ns" else cv.INPAINT_TELEA
            known = h[mask < 1]
            h_max, h_min = float(known.max()), float(known.min())
            scale = (h_max - h_min) or 1.0
            h8 = ((h - h_min) * 255 / scale).astype(np.uint8)
            dst = cv.inpaint(h8, mask, 1, flag)
            out = dst.astype(np.float32) * scale / 255 + h_min
            return torch.from_numpy(out).to(elevation_map.device)
        out = elevation_map[0]
        m = (~invalid).to(out.dtype)
        for _ in range(32):
            s = stencil.uniform_smooth(out * m, passes=1, size=3)
            c = stencil.uniform_smooth(m, passes=1, size=3)
            fill = s / torch.clamp(c, min=1e-6)
            out = torch.where(m > 0.5, out, fill)
            m = torch.maximum(m, (c > 1e-6).to(m.dtype))
        return out


class Erosion(PluginBase):
    """cv2.erode of the normalized-uint8 layer on the host (a NumPy minimum
    over the window without cv2), as the reference and the JAX package do."""

    def __init__(
        self,
        cell_n: int = 100,
        input_layer_name: str = "traversability",
        kernel_size: int = 3,
        iterations: int = 1,
        reverse: bool = False,
        default_layer_name: str = "traversability",
        **kw,
    ):
        self.input_layer_name = input_layer_name
        self.kernel_size = int(kernel_size)
        self.iterations = int(iterations)
        self.reverse = bool(reverse)
        self.default_layer_name = default_layer_name

    def __call__(self, elevation_map, layer_names, plugin_layers, plugin_layer_names,
                 semantic_map, semantic_layer_names, *args):
        layer = self.get_layer_data(
            elevation_map, layer_names, plugin_layers, plugin_layer_names,
            semantic_map, semantic_layer_names, self.input_layer_name,
        )
        if layer is None:
            layer = self.get_layer_data(
                elevation_map, layer_names, plugin_layers, plugin_layer_names,
                semantic_map, semantic_layer_names, self.default_layer_name,
            )
        if layer is None:
            layer = elevation_map[3]
        x = _host(layer)
        if self.reverse:
            x = 1 - x
        lo, hi = float(x.min()), float(x.max())
        scale = (hi - lo) or 1.0
        x8 = ((x - lo) * 255 / scale).astype(np.uint8)
        cv = _cv2()
        if cv is not None:
            kernel = np.ones((self.kernel_size, self.kernel_size), np.uint8)
            x8 = cv.erode(x8, kernel, iterations=self.iterations)
        else:
            pad = self.kernel_size // 2
            for _ in range(self.iterations):
                padded = np.pad(x8, pad, mode="edge")
                views = [
                    padded[dy : dy + x8.shape[0], dx : dx + x8.shape[1]]
                    for dy in range(self.kernel_size)
                    for dx in range(self.kernel_size)
                ]
                x8 = np.minimum.reduce(views)
        out = x8.astype(np.float32) * scale / 255 + lo
        if self.reverse:
            out = 1 - out
        return torch.from_numpy(np.asarray(out, np.float32)).to(elevation_map.device)


def _pascal_color_map(n: int = 256) -> np.ndarray:
    """VOC-style colormap with the reference's overrides
    (semantic_filter.py:36-62)."""
    cmap = np.zeros((n + 1, 3), np.uint8)
    for i in range(n + 1):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    cmap[1] = [81, 113, 162]
    cmap[2] = [81, 113, 162]
    cmap[3] = [188, 63, 59]
    return cmap[1:]


def _matching(names: Sequence[str], patterns: Sequence[str]) -> List[int]:
    return [i for i, nm in enumerate(names) if any(re.match(p, nm) for p in patterns)]


def _matching_layers(patterns, elevation_map, layer_names, plugin_layers, plugin_layer_names,
                     semantic_map, semantic_layer_names) -> List[torch.Tensor]:
    """The layers whose names ``re.match`` one of ``patterns``: core, then
    plugin, then semantic layers, each group in its own order."""
    data = []
    for m, names in (
        (elevation_map, layer_names),
        (plugin_layers, plugin_layer_names),
        (semantic_map, semantic_layer_names),
    ):
        idx = _matching(list(names), patterns)
        if idx:
            data.append(m[torch.tensor(idx, device=m.device)])
    return data


class SemanticFilter(PluginBase):
    """The packed VOC colour of each cell's most likely class (the first of
    equal maxima; a NaN counts as the maximum). The colours are float32
    views of uint32 bits and are only gathered, bit for bit."""

    def __init__(self, cell_n: int = 100, classes: Sequence[str] = ("person", "grass"), **kw):
        self.classes = list(classes)
        colors = _pascal_color_map(255).astype(np.uint32)
        packed = (colors[:, 0] << 16) | (colors[:, 1] << 8) | colors[:, 2]
        self.color_encoding = torch.from_numpy(packed.view(np.float32).copy())

    def __call__(self, elevation_map, layer_names, plugin_layers, plugin_layer_names,
                 semantic_map, semantic_layer_names, *args):
        data = _matching_layers(self.classes, elevation_map, layer_names, plugin_layers, plugin_layer_names,
                                semantic_map, semantic_layer_names)
        if data:
            class_id = torch.argmax(torch.cat(data, dim=0), dim=0)
        else:
            class_id = torch.zeros(elevation_map[0].shape, dtype=torch.int64, device=elevation_map.device)
        if self.color_encoding.device != elevation_map.device:
            self.color_encoding = self.color_encoding.to(elevation_map.device)
        return self.color_encoding[class_id]


class SemanticTraversability(PluginBase):
    def __init__(self, cell_n: int = 100, layers: Sequence[str] = ("traversability",),
                 thresholds: Sequence[float] = (0.5,), type: Sequence[str] = ("traversability",), **kw):
        self.layers = list(layers)
        self.thresholds = list(thresholds)
        self.types = list(type)

    def __call__(self, elevation_map, layer_names, plugin_layers, plugin_layer_names,
                 semantic_map, semantic_layer_names, *args):
        votes = torch.zeros(elevation_map[0].shape, dtype=torch.float32, device=elevation_map.device)
        for name, thresh, typ in zip(self.layers, self.thresholds, self.types):
            layer = self.get_layer_data(
                elevation_map, layer_names, plugin_layers, plugin_layer_names,
                semantic_map, semantic_layer_names, name,
            )
            if layer is None:
                continue
            if typ == "traversability":
                votes = votes + (layer <= thresh)
            else:
                votes = votes + (layer >= thresh)
        return torch.where(votes <= 0.9, 0.1, 1.0)


class MaxLayerFilter(PluginBase):
    """Min or max over layers, each optionally defaulted where 0, reversed,
    scaled and thresholded. Only float YAML values scale and threshold (the
    reference's ``isinstance`` tests: ``thresholds: [False]`` means none)."""

    def __init__(self, cell_n: int = 100, layers: Sequence[str] = ("traversability",),
                 reverse: Sequence[bool] = (False,), min_or_max: str = "max",
                 thresholds: Sequence[Any] = (False,), scales: Sequence[Any] = (1.0,),
                 default_value: Any = 0.0, **kw):
        self.layers = list(layers)
        self.reverse = list(reverse)
        self.min_or_max = min_or_max
        self.thresholds = list(thresholds)
        self.scales = list(scales)
        self.default_value = default_value

    def __call__(self, elevation_map, layer_names, plugin_layers, plugin_layer_names,
                 semantic_map, semantic_layer_names, *args):
        stack = []
        for it, name in enumerate(self.layers):
            layer = self.get_layer_data(
                elevation_map, layer_names, plugin_layers, plugin_layer_names,
                semantic_map, semantic_layer_names, name,
            )
            if layer is None:
                continue
            if isinstance(self.default_value, float):
                layer = torch.where(layer == 0.0, float(self.default_value), layer)
            elif isinstance(self.default_value, str):
                dflt = self.get_layer_data(
                    elevation_map, layer_names, plugin_layers, plugin_layer_names,
                    semantic_map, semantic_layer_names, self.default_value,
                )
                if dflt is not None:
                    layer = torch.where(layer == 0.0, dflt, layer)
            if it < len(self.reverse) and self.reverse[it]:
                layer = 1.0 - layer
            if it < len(self.scales) and isinstance(self.scales[it], float):
                layer = layer * float(self.scales[it])
            if it < len(self.thresholds) and isinstance(self.thresholds[it], float):
                layer = torch.where(layer > float(self.thresholds[it]), 1.0, 0.0)
            stack.append(layer)
        if not stack:
            if isinstance(self.default_value, float):
                return torch.full(elevation_map[0].shape, float(self.default_value), device=elevation_map.device)
            return elevation_map[3]
        arr = torch.stack(stack, dim=0)
        return torch.amin(arr, dim=0) if self.min_or_max == "min" else torch.amax(arr, dim=0)


class RobotCentricElevation(PluginBase):
    """Rotate valid heights into the base frame
    (robot_centric_elevation.py:25-121)."""

    def __init__(self, cell_n: int = 100, resolution: float = 0.04,
                 threshold: float = 0.0, use_threshold: bool = False, **kw):
        self.resolution = float(resolution)
        self.threshold = float(threshold)
        self.use_threshold = bool(use_threshold)

    def __call__(self, elevation_map, layer_names, plugin_layers, plugin_layer_names,
                 semantic_map, semantic_layer_names, rotation, *args):
        n = elevation_map.shape[-1]
        dev = elevation_map.device
        R = rotation.to(dev, torch.float32) if rotation is not None else torch.eye(3, device=dev)
        i = torch.arange(n * n, device=dev)
        # the reference derives cell coords from the flat index with integer
        # division *before* scaling (robot_centric_elevation.py:52-58)
        rx = (i // n).to(torch.float32) * self.resolution
        ry = (i % n).to(torch.float32) * self.resolution
        rz = elevation_map[0].reshape(-1)
        z_b = R[2, 0] * rx + R[2, 1] * ry + R[2, 2] * rz
        if self.use_threshold:
            z_b = torch.where(z_b >= self.threshold, 1.0, 0.0)
        valid = elevation_map[2].reshape(-1) > 0.5
        out = torch.where(valid, z_b, rz)
        return out.reshape(n, n)


class FeaturesPca(PluginBase):
    """PCA of feature layers -> packed RGB (features_pca.py:42-96): the three
    leading principal axes of the clipped features, each projection scaled
    to 0..255. An eigenvector's sign is the solver's choice, so a channel
    may come out mirrored (255 - c) on another solver. A NaN feature makes
    every cell 0, as the JAX package's unsigned conversion of NaN does."""

    def __init__(self, cell_n: int = 100, process_layer_names: Sequence[str] = (), **kw):
        self.process_layer_names = list(process_layer_names)

    def __call__(self, elevation_map, layer_names, plugin_layers, plugin_layer_names,
                 semantic_map, semantic_layer_names, *args):
        data = _matching_layers(self.process_layer_names, elevation_map, layer_names, plugin_layers,
                                plugin_layer_names, semantic_map, semantic_layer_names)
        if not data:
            return torch.zeros_like(elevation_map[0])
        feats = torch.clamp(torch.cat(data, dim=0), -1, 1)   # (F, H, W)
        n = feats.shape[-1]
        x = feats.reshape(feats.shape[0], -1).T               # (H*W, F)
        mu = torch.mean(x, dim=0, keepdim=True)
        xc = x - mu
        # products summed explicitly: float32 whatever the matmul precision flags say
        cov = (xc[:, :, None] * xc[:, None, :]).sum(dim=0)
        finite = torch.isfinite(cov).all()
        # the solver refuses a NaN matrix; JAX's returns NaN vectors
        _, vecs = torch.linalg.eigh(torch.where(finite, cov, 0.0))
        vecs = torch.where(finite, vecs, math.nan)
        comps = torch.flip(vecs[:, -3:], dims=(1,))           # top-3 principal axes
        proj = (xc[:, :, None] * comps[None, :, :]).sum(dim=1)  # (H*W, 3)
        pmin = torch.amin(proj, dim=0)
        pmax = torch.amax(proj, dim=0)
        scale = torch.where(pmax - pmin == 0, 1.0, pmax - pmin)
        img = _to_uint32((proj - pmin) / scale * 255)
        packed = uint_to_rgb_float(img[:, 0], img[:, 1], img[:, 2])
        return packed.reshape(n, n)


def _to_uint32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> uint32 values (as int64) the way XLA converts: truncated
    toward zero, saturated at 0 and 2^32 - 1, NaN to 0."""
    v = torch.where(torch.isnan(v), 0.0, v).clamp(0.0, 2.0**32)
    return v.to(torch.int64).clamp(max=2**32 - 1)


REGISTRY: Dict[str, Any] = {
    "min_filter": MinFilter,
    "max_filter": MaxFilter,
    "smooth_filter": SmoothFilter,
    "inpainting": Inpainting,
    "erosion": Erosion,
    "semantic_filter": SemanticFilter,
    "semantic_traversability": SemanticTraversability,
    "max_layer_filter": MaxLayerFilter,
    "robot_centric_elevation": RobotCentricElevation,
    "features_pca": FeaturesPca,
}
