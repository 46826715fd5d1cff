"""Post-processing plugin system (PluginManager equivalent).

PyTorch counterpart of ``elevation_mapping_cupy_tpu/plugins/manager.py``,
after the reference plugin architecture (plugins/plugin_manager.py:120-247):
YAML-configured, computed on layer export, with the same call data (core
layers, plugin layers, semantic layers, rotation, shift elements).

The plugin layers are one (P, n, n) tensor on the map's device. A plugin
that reads another plugin's layer sees its last computed value, and zeros
before that layer's first export.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

__all__ = ["PluginParams", "PluginBase", "PluginManager"]


@dataclass
class PluginParams:
    name: str
    layer_name: str
    fill_nan: bool = False
    is_height_layer: bool = False


class PluginBase:
    """Base class for post-processing plugins.

    __call__ receives (elevation_map (7,H,W), layer_names, plugin_layers,
    plugin_layer_names, semantic_map, semantic_layer_names, rotation,
    elements_to_shift), tensors on the map's device, and returns an (H, W)
    tensor there.
    """

    def __init__(self, **kwargs: Any) -> None:
        pass

    def __call__(self, *args: Any, **kwargs: Any):
        raise NotImplementedError

    @staticmethod
    def get_layer_data(
        elevation_map,
        layer_names: Sequence[str],
        plugin_layers,
        plugin_layer_names: Sequence[str],
        semantic_map,
        semantic_layer_names: Sequence[str],
        name: str,
    ):
        if name in layer_names:
            return elevation_map[list(layer_names).index(name)]
        if name in plugin_layer_names:
            return plugin_layers[list(plugin_layer_names).index(name)]
        if name in semantic_layer_names:
            return semantic_map[list(semantic_layer_names).index(name)]
        return None


class PluginManager:
    """Loads plugin settings (reference plugin_config.yaml schema) and computes
    plugin layers on demand."""

    def __init__(self, cell_n: int, device: Union[str, torch.device] = "cuda"):
        self.cell_n = cell_n
        self.device = torch.device(device)
        self.plugins: List[PluginBase] = []
        self.plugin_params: List[PluginParams] = []
        self.layers = torch.zeros((0, cell_n, cell_n), dtype=torch.float32, device=self.device)

    # -- configuration ------------------------------------------------------
    def init(self, plugin_params: List[PluginParams], extra_params: List[Dict]) -> None:
        from . import builtin

        self.plugin_params = plugin_params
        self.plugins = []
        for param, extra in zip(plugin_params, extra_params):
            cls = builtin.REGISTRY.get(param.name)
            if cls is None:
                raise ValueError(f"unknown plugin {param.name!r}")
            kw = dict(extra)
            kw["cell_n"] = self.cell_n
            self.plugins.append(cls(**kw))
        self.layers = torch.zeros(
            (len(self.plugins), self.cell_n, self.cell_n), dtype=torch.float32, device=self.device
        )

    def load_plugin_settings(self, file_path: str) -> None:
        import yaml

        with open(file_path, "r") as f:
            cfg = yaml.safe_load(f) or {}
        plugin_params, extra_params = [], []
        for k, v in cfg.items():
            if not v.get("enable", False):
                continue
            plugin_params.append(
                PluginParams(
                    name=v.get("type", k),
                    layer_name=v["layer_name"],
                    fill_nan=v.get("fill_nan", False),
                    is_height_layer=v.get("is_height_layer", False),
                )
            )
            extra_params.append(dict(v.get("extra_params", {}) or {}))
        self.init(plugin_params, extra_params)

    # -- queries ------------------------------------------------------------
    @property
    def layer_names(self) -> List[str]:
        return [p.layer_name for p in self.plugin_params]

    @property
    def plugin_names(self) -> List[str]:
        return [p.name for p in self.plugin_params]

    def get_layer_index_with_name(self, name: str) -> Optional[int]:
        try:
            return self.layer_names.index(name)
        except ValueError:
            return None

    def update_with_name(
        self,
        name: str,
        elevation_map: torch.Tensor,
        layer_names: Sequence[str],
        semantic_map: Optional[torch.Tensor] = None,
        semantic_layer_names: Sequence[str] = (),
        rotation: Optional[torch.Tensor] = None,
        elements_to_shift: Optional[Dict] = None,
    ) -> None:
        idx = self.get_layer_index_with_name(name)
        if idx is None or idx >= len(self.plugins):
            return
        if semantic_map is None:
            semantic_map = elevation_map.new_zeros((0,) + tuple(elevation_map.shape[1:]))
        out = self.plugins[idx](
            elevation_map,
            list(layer_names),
            self.layers,
            self.layer_names,
            semantic_map,
            list(semantic_layer_names),
            rotation,
            elements_to_shift or {},
        )
        self.layers[idx] = out.to(device=self.layers.device, dtype=torch.float32)

    def get_map_with_name(self, name: str) -> Optional[torch.Tensor]:
        idx = self.get_layer_index_with_name(name)
        if idx is not None:
            return self.layers[idx]
        return None

    def get_param_with_name(self, name: str) -> Optional[PluginParams]:
        idx = self.get_layer_index_with_name(name)
        if idx is not None:
            return self.plugin_params[idx]
        return None
