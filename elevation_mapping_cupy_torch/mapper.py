"""Stateful elevation map: the reference ElevationMap's API on PyTorch.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/mapper.py``: point
clouds with or without semantic channels, images, map motion, maintenance
timers, the core, normal, semantic and plugin layer exports, the named
getters, polygon safety queries, ``initialize_map``, and npz checkpoints in
the JAX package's schema (a checkpoint saved by either package loads in the
other). Everything a caller reads back is host NumPy; internal callers read
layers on the device (``_layer_tensor``).

Colour and class-max layers hold integers packed into the bits of a float32
(``semantic/fusions.py``): they are exported, shifted and checkpointed as
they are, bit for bit, and nothing here does arithmetic on them.

The map lives on a CUDA device unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import core, tracing
from .config import DEFAULT_CORE_LAYERS, MapConfig
from .nn.traversability import DEFAULT_WEIGHT_FILE, TravFilter, default_weights, load_weights_npz
from .ops import polygon as poly_ops
from .ops import stencil
from .ops.raycast import AdaptiveExactRouter
from .plugins import PluginManager
from .state import MapState, init_state, state_from_numpy, state_to_numpy
from .utils.hull import convex_hull

__all__ = ["ElevationMap", "resolve_device"]

_NORMAL_LAYERS = ("normal_x", "normal_y", "normal_z")


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` means CUDA. A CUDA device without a card raises: nothing
    falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "elevation_mapping_cupy_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def _export(state: MapState, cfg: MapConfig, name: str, flip: bool) -> torch.Tensor:
    """Crop, NaN-fill, z-offset and optional double flip of one layer (the JAX
    package's ``_export_layer``)."""
    L = state.layers
    nan = torch.full_like(L[0], math.nan)

    def pub(m, fill_nan=False, add_z=False):
        if fill_nan:
            m = torch.where(L[2] > 0.5, m, nan)
        if add_z:
            m = m + state.center[2]
        return m[1:-1, 1:-1]

    if name == "elevation":
        m = pub(L[0], fill_nan=True, add_z=True)
    elif name == "variance":
        m = pub(L[1])
    elif name == "is_valid":
        m = pub(L[2])
    elif name == "traversability":
        trav = torch.where((L[2] + L[6]) > 0.5, L[3], nan)
        buf = nan.clone()
        buf[3:-3, 3:-3] = trav[3:-3, 3:-3]
        m = buf[1:-1, 1:-1]
    elif name == "time":
        m = pub(L[4])
    elif name in ("upper_bound", "is_upper_bound"):
        if cfg.use_only_above_for_upper_bound:
            valid = ((L[5] > 0.0) & (L[6] > 0.5)) | (L[2] > 0.5)
        else:
            valid = (L[2] > 0.5) | (L[6] > 0.5)
        if name == "upper_bound":
            m = torch.where(valid, L[5], nan)[1:-1, 1:-1] + state.center[2]
        else:
            m = torch.where(valid, L[6], nan)[1:-1, 1:-1]
    elif name in _NORMAL_LAYERS:
        m = state.normal[_NORMAL_LAYERS.index(name)][1:-1, 1:-1]
    elif name in cfg.semantic_layers:
        m = state.semantic[cfg.semantic_layers.index(name)][1:-1, 1:-1]
    else:
        raise KeyError(name)
    if flip:
        m = torch.flip(m, dims=(0, 1))
    return m


class ElevationMap:
    def __init__(
        self,
        cfg: MapConfig,
        weights: Optional[TravFilter] = None,
        weight_file: Optional[str] = None,
        plugin_config_file: Optional[str] = None,
        device: Union[None, str, torch.device] = None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cell_n = cfg.cell_n
        self.resolution = cfg.resolution
        self.map_length = cfg.map_length
        self.layer_names = list(DEFAULT_CORE_LAYERS)

        if weights is None:
            if weight_file:
                weights = load_weights_npz(weight_file)
            elif os.path.exists(DEFAULT_WEIGHT_FILE):
                weights = load_weights_npz(DEFAULT_WEIGHT_FILE)
            else:
                weights = default_weights()
        self.weights = weights.to(self.device)
        self.state = init_state(cfg, self.device)
        self.untraversable_polygon = np.zeros((1, 2))

        self.plugin_manager = PluginManager(cell_n=self.cell_n, device=self.device)
        if plugin_config_file:
            self.plugin_manager.load_plugin_settings(plugin_config_file)
        # gated/flat routing of the exact cleanup (raycast_exact_impl="auto"):
        # the last gated update's survivor fraction routes the next update
        self._exact_router = AdaptiveExactRouter(cfg)

    # ------------------------------------------------------------------ util
    @property
    def semantic_layer_names(self) -> List[str]:
        return list(self.cfg.semantic_layers)

    @property
    def center(self) -> np.ndarray:
        return tracing.read_back(self.state.center)

    def _tensor(self, x) -> torch.Tensor:
        return tracing.upload(np.asarray(x, np.float32), self.device)

    def _bucket(self, n: int) -> int:
        return max(1024, 1 << int(math.ceil(math.log2(max(n, 1)))))

    def _pad_points(self, pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Pad to a power-of-two bucket (as the JAX mapper does, so both see
        the same padded cloud), on the host: (points, mask)."""
        n = len(pts)
        m = self._bucket(n)
        out = np.zeros((m, pts.shape[1]), np.float32)
        out[:n] = pts
        mask = np.zeros((m,), bool)
        mask[:n] = True
        return out, mask

    def _grow_semantic_layers(self, new_channels: Sequence[str]) -> None:
        """Dynamic add_layer equivalent (semantic_map.py:80-97): grow the
        config and zero-pad the semantic state tensors."""
        added = [c for c in new_channels if c not in self.cfg.semantic_layers]
        if not added:
            return
        self.cfg = self.cfg.replace(semantic_layers=tuple(self.cfg.semantic_layers) + tuple(added))
        st = self.state

        def grown(x: torch.Tensor) -> torch.Tensor:
            pad = torch.zeros((len(added),) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
            return torch.cat([x, pad])

        self.state = st._replace(semantic=grown(st.semantic), sem_new=grown(st.sem_new), id_max=grown(st.id_max))

    # -------------------------------------------------------------- mutation
    def clear(self) -> None:
        self.state = core.clear(self.state, self.cfg)

    def get_position(self, position) -> None:
        position[0][:] = self.center

    def move(self, delta_position) -> None:
        self.state = core.move(self.state, self._tensor(delta_position), self.cfg)

    def move_to(self, position, R) -> None:
        with tracing.span("mapper.move_to"):
            self.state = core.move_to(self.state, self._tensor(position), self._tensor(R), self.cfg)

    def input_pointcloud(
        self,
        raw_points: np.ndarray,
        channels: Sequence[str],
        R: np.ndarray,
        t: np.ndarray,
        position_noise: float,
        orientation_noise: float,
    ) -> None:
        """channels: names of all columns; the first three must be x, y, z.
        Further columns are semantic channels: those that resolve to a
        fusion get a layer (grown on first sight) and are fused in the same
        update. For an x/y/z cloud on an exact-march config with
        raycast_exact_impl="auto", the router picks the gated or the flat
        march for this update."""
        with tracing.span("mapper.input_pointcloud"):
            with tracing.span("mapper.filter"):
                raw_points = np.asarray(raw_points, np.float32)
                if len(channels) != raw_points.shape[1]:
                    raise ValueError(
                        f"channels names every column: got {len(channels)} names "
                        f"for {raw_points.shape[1]} columns"
                    )
                raw_points = raw_points[~np.isnan(raw_points[:, :3]).any(axis=1)]
                additional = tuple(channels[3:])
                self._grow_semantic_layers([c for c in additional if self.cfg.fusion_for_channel(c, "pointcloud")])
                pts, mask = self._pad_points(raw_points)
            with tracing.span("mapper.upload"):
                args = (self.state, tracing.upload(pts, self.device), tracing.upload(mask, self.device),
                        self._tensor(R), self._tensor(t), float(position_noise), float(orientation_noise),
                        self.weights)
            if additional:
                self.state = core.update_pointcloud_semantic(*args, self.cfg, additional)
                return
            with tracing.span("mapper.route"):
                impl = self._exact_router.route()
            if impl is None:
                self.state = core.update_pointcloud(*args, self.cfg)
            else:
                self.state, aux = core.update_pointcloud_aux(*args, self.cfg.replace(raycast_exact_impl=impl))
                self._exact_router.observe(impl, aux["gate_survivor_frac"])

    def warm_raycast_impls(self, n_points: Optional[int] = None) -> List[str]:
        """Run both routed exact cleanups (gated, then flat) once, on a
        throwaway state with the padded bucket of ``n_points`` (default
        cfg.max_points), so that the first live update finds everything it
        needs (on the card: K1 and K2 built and loaded). Returns the impls
        run, [] when routing is inactive. The map's state is not touched."""
        if not self._exact_router._eligible:
            return []
        m = self._bucket(n_points or self.cfg.max_points)
        pts = torch.zeros((m, 3), dtype=torch.float32, device=self.device)
        mask = torch.zeros((m,), dtype=torch.bool, device=self.device)
        R = torch.eye(3, device=self.device)
        t = torch.zeros(3, device=self.device)
        warmed = []
        for impl in ("gated", "flat"):
            cfg_step = self.cfg.replace(raycast_exact_impl=impl)
            core.update_pointcloud_aux(
                init_state(cfg_step, self.device), pts, mask, R, t, 0.0, 0.0, self.weights, cfg_step
            )
            warmed.append(impl)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return warmed

    def input_image(
        self,
        image: Union[np.ndarray, Sequence[np.ndarray]],
        channels: Sequence[str],
        R: np.ndarray,
        t: np.ndarray,
        K: np.ndarray,
        D: np.ndarray,
        distortion_model: str = "radtan",
        image_height: Optional[int] = None,
        image_width: Optional[int] = None,
    ) -> None:
        """Fuse an image (a (C, H, W) array, a list of (H, W) planes, or one
        mono (H, W) plane) into the semantic layers named by ``channels``; a
        colour channel takes three planes. ``image_height`` and
        ``image_width`` belong to the reference's signature; the image's own
        shape is what counts."""
        if isinstance(image, (list, tuple)):
            img = np.stack([np.asarray(c, np.float32) for c in image], axis=0)
        else:
            img = np.asarray(image, np.float32)
        if img.ndim == 2:
            img = img[None]
        D = np.asarray(D, np.float32).reshape(-1)
        if len(D) < 4:
            D = np.zeros(5, np.float32)
        elif len(D) == 4:
            D = np.concatenate([D, np.zeros(1, np.float32)])
        else:
            D = D[:5]
        if distortion_model != "radtan":
            D = D * 0  # other models unimplemented in the reference too
        chans = tuple(channels)
        self._grow_semantic_layers([c for c in chans if self.cfg.fusion_for_channel(c, "image")])
        self.state = core.input_image(
            self.state,
            self._tensor(img),
            self._tensor(R),
            self._tensor(t),
            self._tensor(np.asarray(K, np.float32).reshape(3, 3)),
            self._tensor(D),
            self.cfg,
            chans,
        )

    def update_variance(self) -> None:
        self.state = core.update_variance(self.state, self.cfg)

    def update_time(self) -> None:
        self.state = core.update_time(self.state, self.cfg)

    def get_additive_mean_error(self) -> float:
        """Accumulated drift estimate (elevation_mapping.py:412-418)."""
        return float(tracing.read_back(self.state.additive_mean_error))

    def update_upper_bound_with_valid_elevation(self) -> None:
        self.state = core.update_upper_bound_with_valid_elevation(self.state)

    def update_normal(self, input_map=None) -> None:
        m = self.state.layers[0] if input_map is None else self._tensor(input_map)
        self.state = core.update_normal(self.state, m, self.cfg)

    # --------------------------------------------------------------- exports
    def _exportable(self, name: str) -> bool:
        """A layer that ``_export`` crops in one go (no plugin)."""
        return name in self.layer_names or name in _NORMAL_LAYERS or name in self.cfg.semantic_layers

    def exists_layer(self, name: str) -> bool:
        return self._exportable(name) or name in self.plugin_manager.layer_names

    def _process_for_publish(self, m: torch.Tensor, fill_nan: bool = False, add_z: bool = False) -> torch.Tensor:
        if fill_nan:
            m = torch.where(self.state.layers[2] > 0.5, m, math.nan)
        if add_z:
            m = m + self.state.center[2]
        return m[1:-1, 1:-1]

    def _update_plugin(self, name: str) -> torch.Tensor:
        """Compute plugin layer ``name`` from the current state; returns the
        uncropped layer on the map's device."""
        self.plugin_manager.update_with_name(
            name,
            self.state.layers,
            self.layer_names,
            self.state.semantic,
            self.semantic_layer_names,
            self.state.rotation,
            {"id_max": self.state.id_max},
        )
        return self.plugin_manager.get_map_with_name(name)

    def _get_named_map(self, name: str) -> Optional[torch.Tensor]:
        """The named layer as published, unflipped, on the map's device (a
        plugin layer is computed first); None for an unknown name."""
        if self._exportable(name):
            return _export(self.state, self.cfg, name, False)
        if name in self.plugin_manager.layer_names:
            m = self._update_plugin(name)
            p = self.plugin_manager.get_param_with_name(name)
            return self._process_for_publish(m, fill_nan=p.fill_nan, add_z=p.is_height_layer)
        return None

    def _layer_tensor(self, name: str) -> Optional[torch.Tensor]:
        """Uncropped layer on the map's device (``get_layer`` without the
        copy to the host)."""
        if name in self.layer_names:
            return self.state.layers[self.layer_names.index(name)]
        if name in self.semantic_layer_names:
            return self.state.semantic[self.semantic_layer_names.index(name)]
        if name in self.plugin_manager.layer_names:
            return self._update_plugin(name)
        return None

    def get_layer(self, name: str) -> Optional[np.ndarray]:
        """Uncropped layer access (elevation_mapping.py:807-835), as host
        NumPy; None for an unknown name."""
        m = self._layer_tensor(name)
        return None if m is None else tracing.read_back(m, copy=True)

    # the named getters: unflipped exports, as host NumPy (a copy: a crop of
    # a CPU map's layer is a view of its state)
    def _named(self, name: str) -> np.ndarray:
        return tracing.read_back(_export(self.state, self.cfg, name, False), copy=True)

    def get_elevation(self) -> np.ndarray:
        return self._named("elevation")

    def get_variance(self) -> np.ndarray:
        return self._named("variance")

    def get_traversability(self) -> np.ndarray:
        return self._named("traversability")

    def get_time(self) -> np.ndarray:
        return self._named("time")

    def get_upper_bound(self) -> np.ndarray:
        return self._named("upper_bound")

    def get_is_upper_bound(self) -> np.ndarray:
        return self._named("is_upper_bound")

    def get_normal_maps(self) -> np.ndarray:
        return tracing.read_back(torch.flip(self.state.normal[:, 1:-1, 1:-1], dims=(1, 2)))

    def get_normal_ref(self, nx, ny, nz) -> None:
        maps = self.get_normal_maps()
        nx[...], ny[...], nz[...] = maps[0], maps[1], maps[2]

    def get_map_with_name_ref(self, name: str, data: np.ndarray) -> None:
        """Write the named layer (cropped and double-flipped like the
        reference GridMap export, elevation_mapping.py:720-775) into ``data``;
        a plugin layer is computed first."""
        m = self._get_named_map(name)
        if m is None:
            print(f"Layer {name} is not in the map")
            return
        data[...] = tracing.read_back(torch.flip(m, dims=(0, 1)))

    def get_layers(self, names) -> Dict[str, np.ndarray]:
        """Several layers in one device->host copy: {name: (n, n) float32},
        flipped like the GridMap export. As in the JAX package, the core,
        normal and semantic layers come first and the plugin layers after
        them, each group in the order asked."""
        names = list(names)
        order = [nm for nm in names if self._exportable(nm)]
        order += [nm for nm in names if not self._exportable(nm)]
        maps = {}
        for nm in order:
            if nm in maps:
                continue
            m = self._get_named_map(nm)
            if m is None:
                print(f"Layer {nm} is not in the map")
                continue
            maps[nm] = m
        if not maps:
            return {}
        stacked = tracing.read_back(torch.flip(torch.stack(list(maps.values())), dims=(1, 2)))
        return {nm: stacked[i] for i, nm in enumerate(maps)}

    # --------------------------------------------------------------- queries
    def _polygon_stats(self, checker: torch.Tensor, poly_padded: torch.Tensor, n_vertices: int):
        """Polygon mask, masked traversability statistics and the unsafe-cell
        mask on the device, read back once: (t, max untraversability,
        unsafe (n-2, n-2) bool)."""
        cfg = self.cfg
        mask = poly_ops.polygon_mask(poly_padded, n_vertices, self.state.center[:2], cfg)
        masked, masked_isvalid = poly_ops.masked_traversability(self.state.layers, mask, checker)
        s = torch.sum(masked_isvalid)
        t = torch.where(s > 0, torch.sum(masked) / torch.clamp(s, min=1), 0.0)
        over = masked > (1 - cfg.safe_thresh)
        host = tracing.read_back(torch.cat([t.view(1), torch.amax(masked).view(1), over.reshape(-1).to(t.dtype)]))
        return float(host[0]), float(host[1]), host[2:].reshape(over.shape) > 0.5

    def get_polygon_traversability(self, polygon, result) -> int:
        """Polygon safety check (elevation_mapping.py:837-889): writes
        [is_safe, mean traversability cost, area] into ``result`` and returns
        the vertex count of the unsafe cells' hull (0 without one)."""
        polygon = np.asarray(polygon, np.float32)
        area = _shoelace(polygon)
        center = self.center
        pmin = center[:2] - self.map_length / 2 + self.resolution
        pmax = center[:2] + self.map_length / 2 - self.resolution
        clipped = polygon.copy()
        clipped[:, 0] = clipped[:, 0].clip(pmin[0], pmax[0])
        clipped[:, 1] = clipped[:, 1].clip(pmin[1], pmax[1])
        clipped_area = _shoelace(clipped)

        nv = clipped.shape[0]
        vpad = max(8, 1 << int(math.ceil(math.log2(max(nv, 1)))))
        poly_padded = np.zeros((vpad, 2), np.float32)
        poly_padded[:nv] = clipped
        checker = self._layer_tensor(self.cfg.checker_layer)
        t, max_untrav, over = self._polygon_stats(checker, tracing.upload(poly_padded, self.device), nv)
        is_safe = True
        if over.sum() > self.cfg.max_unsafe_n:
            is_safe = False
        elif max_untrav > 1 - self.cfg.safe_min_thresh:
            is_safe = False

        un_poly = None
        xy = np.argwhere(over)
        if len(xy) >= 3:
            un_poly = convex_hull(xy.astype(np.float64))
        n_unpoly = 0
        if un_poly is not None:
            un_poly = center[:2].reshape(1, 2) + (un_poly - self.cell_n / 2.0) * self.resolution
            n_unpoly = un_poly.shape[0]
            self.untraversable_polygon = un_poly
        else:
            self.untraversable_polygon = np.zeros((0, 2))
        if clipped_area < 0.001:
            is_safe = False
        result[...] = np.array([is_safe, t, area])
        return n_unpoly

    def get_untraversable_polygon(self, out) -> None:
        out[...] = self.untraversable_polygon

    # ------------------------------------------------------------------ init
    def initialize_map(self, points, method: str = "cubic") -> None:
        """Sparse-point initialization via scipy griddata on the host
        (map_initializer.py:25-62 + elevation_mapping.py:899-922), then two
        dilation fills and the upper bound on the device."""
        from scipy.interpolate import griddata

        self.clear()
        pts = np.asarray(points, np.float64)
        center = self.center
        indices = ((pts[:, :2] - center[:2].reshape(1, 2)) / self.resolution + self.cell_n / 2).astype(np.int32)
        values_z = pts[:, 2] - center[2]

        layers = self.state.layers.cpu().numpy().copy()
        known = np.argwhere(layers[2] > 0.5)
        known_vals = layers[0][layers[2] > 0.5]
        pidx = np.vstack([known, indices]).astype(np.float64)
        vals = np.concatenate([known_vals, values_z])
        if pidx.shape[0] <= 3:
            raise ValueError("Initialization points must be more than 3.")
        gx, gy = np.mgrid[0 : self.cell_n, 0 : self.cell_n]
        interp = griddata(pidx, vals, (gx, gy), method=method)

        layers[0] = np.nan_to_num(interp)
        layers[1] = np.where(~np.isnan(interp), self.cfg.initialized_variance, self.cfg.initial_variance)
        layers[2] = np.where(~np.isnan(interp), 1.0, 0.0)
        L = torch.from_numpy(layers).to(self.device)
        if self.cfg.dilation_size_initialize > 0:
            for _ in range(2):
                L[0], L[2] = stencil.dilation_fill(L[0], L[2], self.cfg.dilation_size_initialize)
        self.state = core.update_upper_bound_with_valid_elevation(self.state._replace(layers=L))

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, path: str) -> None:
        """npz of every state field, in the JAX package's schema."""
        np.savez(
            path,
            semantic_layers=np.array(self.cfg.semantic_layers, dtype=object),
            **state_to_numpy(self.state),
        )

    def load_checkpoint(self, path: str) -> None:
        # np.savez appends ".npz" when absent; accept the same path here
        if not path.endswith(".npz") and not os.path.exists(path):
            path = path + ".npz"
        with np.load(path, allow_pickle=True) as z:
            sem_layers = tuple(z["semantic_layers"].tolist())
            if sem_layers != self.cfg.semantic_layers:
                self.cfg = self.cfg.replace(semantic_layers=sem_layers)
            self.state = state_from_numpy(z, self.device)


def _shoelace(polygon: np.ndarray) -> float:
    area = 0.0
    for i in range(len(polygon)):
        p1 = polygon[i - 1]
        p2 = polygon[i]
        area += (p1[0] * p2[1] - p1[1] * p2[0]) / 2.0
    return abs(area)
