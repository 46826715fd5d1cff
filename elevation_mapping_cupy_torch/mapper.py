"""Stateful elevation map: the reference ElevationMap's API on PyTorch.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/mapper.py``: point
clouds with or without semantic channels, images, map motion, maintenance
timers, the core, normal and semantic layer exports, and npz checkpoints in
the JAX package's schema (a checkpoint saved by either package loads in the
other). Plugin layers, polygon queries and ``initialize_map`` are not ported
yet. Everything a caller reads back is host NumPy.

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

from . import core
from .config import DEFAULT_CORE_LAYERS, MapConfig
from .nn.traversability import DEFAULT_WEIGHT_FILE, TravFilter, default_weights, load_weights_npz
from .ops.raycast import AdaptiveExactRouter
from .state import MapState, init_state, state_from_numpy, state_to_numpy

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
        # gated/flat routing of the exact cleanup (raycast_exact_impl="auto"):
        # the last gated update's survivor fraction routes the next update
        self._exact_router = AdaptiveExactRouter(cfg)

    # ------------------------------------------------------------------ util
    @property
    def semantic_layer_names(self) -> List[str]:
        return list(self.cfg.semantic_layers)

    @property
    def center(self) -> np.ndarray:
        return self.state.center.cpu().numpy()

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _bucket(self, n: int) -> int:
        return max(1024, 1 << int(math.ceil(math.log2(max(n, 1)))))

    def _pad_points(self, pts: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pad to a power-of-two bucket (as the JAX mapper does, so both see
        the same padded cloud)."""
        n = len(pts)
        m = self._bucket(n)
        out = np.zeros((m, pts.shape[1]), np.float32)
        out[:n] = pts
        mask = np.zeros((m,), bool)
        mask[:n] = True
        return torch.from_numpy(out).to(self.device), torch.from_numpy(mask).to(self.device)

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
        args = (self.state, pts, mask, self._tensor(R), self._tensor(t),
                float(position_noise), float(orientation_noise), self.weights)
        if additional:
            self.state = core.update_pointcloud_semantic(*args, self.cfg, additional)
            return
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
        return float(self.state.additive_mean_error.cpu())

    def update_upper_bound_with_valid_elevation(self) -> None:
        self.state = core.update_upper_bound_with_valid_elevation(self.state)

    def update_normal(self, input_map=None) -> None:
        m = self.state.layers[0] if input_map is None else self._tensor(input_map)
        self.state = core.update_normal(self.state, m, self.cfg)

    # --------------------------------------------------------------- exports
    def _exportable(self, name: str) -> bool:
        return name in self.layer_names or name in _NORMAL_LAYERS or name in self.cfg.semantic_layers

    def exists_layer(self, name: str) -> bool:
        return self._exportable(name)

    def get_map_with_name_ref(self, name: str, data: np.ndarray) -> None:
        """Write the named layer (cropped and double-flipped like the
        reference GridMap export, elevation_mapping.py:720-775) into ``data``."""
        if not self._exportable(name):
            print(f"Layer {name} is not in the map")
            return
        data[...] = _export(self.state, self.cfg, name, True).cpu().numpy()

    def get_layers(self, names) -> Dict[str, np.ndarray]:
        """Several layers in one device->host copy: {name: (n, n) float32},
        flipped like the GridMap export."""
        for nm in names:
            if not self._exportable(nm):
                print(f"Layer {nm} is not in the map")
        names = [nm for nm in names if self._exportable(nm)]
        if not names:
            return {}
        stacked = torch.stack([_export(self.state, self.cfg, nm, True) for nm in names]).cpu().numpy()
        return {nm: stacked[i] for i, nm in enumerate(names)}

    # ------------------------------------------------------ not ported yet
    def get_polygon_traversability(self, *args, **kwargs):
        raise NotImplementedError("polygon queries come with a later slice of the port")

    def get_untraversable_polygon(self, *args, **kwargs):
        raise NotImplementedError("polygon queries come with a later slice of the port")

    def initialize_map(self, *args, **kwargs):
        raise NotImplementedError("initialize_map comes with a later slice of the port")

    def get_layer(self, *args, **kwargs):
        raise NotImplementedError("get_layer comes with the plugin slice of the port")

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
