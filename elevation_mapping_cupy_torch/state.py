"""Map state as a NamedTuple of tensors.

Layer stack layout (indices match reference elevation_mapping.py:69-77, and
``elevation_mapping_cupy_tpu/state.py``):
    0 elevation, 1 variance, 2 is_valid, 3 traversability,
    4 time, 5 upper_bound, 6 is_upper_bound

The functions in ``core.py`` take a state and return a new one; they never
write into the tensors of the state they were given.

A batch of B independent maps is one ``MapState`` whose every field has a
leading axis of B (:func:`init_batch`, :func:`stack_maps`, :func:`take_map`),
which ``core.update_batch_aux`` and ``parallel/batch.py`` step.

``id_max`` is uint32 in the JAX package. PyTorch's uint32 support is thin,
so the port holds it as int64 and converts at the NumPy boundary
(``state_to_numpy`` / ``state_from_numpy``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Sequence, Union

import numpy as np
import torch

from .config import MapConfig

__all__ = [
    "MapState",
    "STATE_FIELDS",
    "init_state",
    "init_batch",
    "stack_maps",
    "stack_tensors",
    "take_map",
    "state_from_numpy",
    "state_to_numpy",
    "trav_weights_from_numpy",
]


class MapState(NamedTuple):
    """Full elevation-map state for one environment (or a batch of them:
    a leading axis on every field)."""

    layers: torch.Tensor          # (7, H, W) float32 core layer stack
    normal: torch.Tensor          # (3, H, W) float32 surface normals
    semantic: torch.Tensor        # (S, H, W) float32 semantic layers (S may be 0)
    sem_new: torch.Tensor         # (S, H, W) float32 per-update accumulation buffer
    id_max: torch.Tensor          # (S, H, W) int64 (uint32 values) class-id bookkeeping
    center: torch.Tensor          # (3,)  map center in world frame
    rotation: torch.Tensor        # (3, 3) last robot base rotation
    mean_error: torch.Tensor      # ()   last drift-compensation mean error
    additive_mean_error: torch.Tensor  # () accumulated drift correction

    @property
    def cell_n(self) -> int:
        return self.layers.shape[-1]


STATE_FIELDS = MapState._fields


def init_state(
    cfg: MapConfig, device: Union[str, torch.device] = "cuda", dtype=torch.float32
) -> MapState:
    """Fresh map state (reference init: elevation_mapping.py:68-95).

    variance starts at ``initial_variance``; traversability starts at 1.
    """
    n = cfg.cell_n
    s = len(cfg.semantic_layers)
    layers = torch.zeros((7, n, n), dtype=dtype, device=device)
    layers[1] = cfg.initial_variance
    layers[3] = 1.0
    return MapState(
        layers=layers,
        normal=torch.zeros((3, n, n), dtype=dtype, device=device),
        semantic=torch.zeros((s, n, n), dtype=dtype, device=device),
        sem_new=torch.zeros((s, n, n), dtype=dtype, device=device),
        id_max=torch.zeros((s, n, n), dtype=torch.int64, device=device),
        center=torch.zeros((3,), dtype=dtype, device=device),
        rotation=torch.eye(3, dtype=dtype, device=device),
        mean_error=torch.zeros((), dtype=dtype, device=device),
        additive_mean_error=torch.zeros((), dtype=dtype, device=device),
    )


def init_batch(
    cfg: MapConfig, batch: int, device: Union[str, torch.device] = "cuda", dtype=torch.float32
) -> MapState:
    """Stack of ``batch`` independent fresh states (leading axis on every
    field), as ``elevation_mapping_cupy_tpu/parallel/batch.py::init_batch``."""
    one = init_state(cfg, device, dtype)
    return MapState(*(x.expand(batch, *x.shape).clone() for x in one))


def stack_maps(states: Sequence[MapState]) -> MapState:
    """One batched state from per-map states (copies)."""
    return MapState(*(torch.stack(fields) for fields in zip(*states)))


def stack_tensors(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-map tensors as one batch; a batch of one is a view of its map."""
    return xs[0][None] if len(xs) == 1 else torch.stack(list(xs))


def take_map(states: MapState, b: int) -> MapState:
    """Map ``b`` of a batched state (views of its tensors)."""
    return MapState(*(x[b] for x in states))


def state_from_numpy(
    src: Union[Mapping[str, Any], Any], device: Union[str, torch.device] = "cuda"
) -> MapState:
    """Build a state from arrays: a mapping of field name -> array (an npz
    checkpoint) or any object with the nine fields as attributes (a JAX
    ``MapState``). ``id_max`` is read as uint32 and held as int64."""
    get = src.__getitem__ if isinstance(src, Mapping) else (lambda k: getattr(src, k))
    out: Dict[str, torch.Tensor] = {}
    for name in STATE_FIELDS:
        a = np.asarray(get(name))
        if name == "id_max":
            a = a.astype(np.uint32).astype(np.int64)
        else:
            a = a.astype(np.float32)
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return MapState(**out)


def state_to_numpy(state: MapState) -> Dict[str, np.ndarray]:
    """Host copy of every field; ``id_max`` goes back to uint32."""
    out = {}
    for name in STATE_FIELDS:
        a = getattr(state, name).detach().cpu().numpy()
        out[name] = a.astype(np.uint32) if name == "id_max" else a
    return out


def trav_weights_from_numpy(w1, w2, w3, w_out, device: Union[str, torch.device] = "cuda"):
    """The traversability CNN built from its four weight arrays
    (OIHW, as ``elevation_mapping_cupy_tpu/nn/traversability.py:22-26``)."""
    from .nn.traversability import TravFilter

    return TravFilter(w1, w2, w3, w_out).to(device)
