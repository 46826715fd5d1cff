"""Batched multi-environment stepping and env-sharded execution.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/parallel/batch.py``. The
JAX package vmaps the per-map update over a leading env axis inside one
jitted program. The port's core takes that axis itself
(``core.update_batch_aux``): every stage runs once over all B maps, K1 is
launched once per scatter stage for the whole batch (three launches per
polar step, whatever B is), and nothing is read back to the host.

Sharding follows PyTorch's one-process-per-card idiom (``mesh.py``): each
process holds and steps its own contiguous part of the env axis
(:func:`shard_states`), and :func:`batch_stats` all-reduces the fleet's
statistics over the process group.
"""

from __future__ import annotations

from typing import Dict, Sequence, Union

import torch
import torch.distributed as tdist

from .. import core, tracing
from .. import state as state_mod
from ..config import MapConfig
from ..nn.traversability import TravFilter
from ..state import MapState
from .mesh import Mesh, axis_part, mesh_device, part_range

__all__ = [
    "init_batch",
    "batched_update",
    "batched_move_to",
    "batched_input_image",
    "shard_states",
    "batch_stats",
]


def init_batch(cfg: MapConfig, batch: int, device: Union[None, str, torch.device] = None) -> MapState:
    """Stack of ``batch`` independent map states on ``device`` (CUDA unless
    asked for ``"cpu"``)."""
    from ..mapper import resolve_device

    return state_mod.init_batch(cfg, batch, resolve_device(device))


@torch.no_grad()
def batched_update(
    states: MapState,            # (B, ...) on every field
    points: torch.Tensor,        # (B, N, 3)
    pad_mask: torch.Tensor,      # (B, N)
    R: torch.Tensor,             # (B, 3, 3)
    t: torch.Tensor,             # (B, 3)
    position_noise: torch.Tensor,  # (B,)
    orientation_noise: torch.Tensor,
    weights: TravFilter,         # shared across envs
    cfg: MapConfig,
) -> MapState:
    """One update step for B independent maps, every stage over the whole
    batch. The inputs are tensors on the states' device.

    Callers rebind (``states = batched_update(states, ...)``), as with the
    JAX function, which donates its input. The port does not reuse the
    input's storage: the input state is left as it was (the contract of
    every function of ``core.py``), so a caller that keeps it holds two
    states for a while.
    """
    with tracing.span("batch.update", maps=states.layers.shape[0]):
        return core.update_batch_aux(
            states, points, pad_mask, R, t, position_noise, orientation_noise, weights, cfg
        )[0]


@torch.no_grad()
def batched_move_to(states: MapState, positions: torch.Tensor, Rs: torch.Tensor, cfg: MapConfig) -> MapState:
    """Batched recentering: each map moves by its own whole-cell shift,
    computed on the device (no read-back). Rebind like
    :func:`batched_update`."""
    return core.move_to(states, positions, Rs, cfg)


@torch.no_grad()
def batched_input_image(
    states: MapState,            # (B, ...)
    images: torch.Tensor,        # (B, C_img, H_i, W_i)
    R: torch.Tensor,             # (B, 3, 3) camera optical rotations
    t: torch.Tensor,             # (B, 3)
    K: torch.Tensor,             # (B, 3, 3) intrinsics
    D: torch.Tensor,             # (B, 5) radtan distortion
    cfg: MapConfig,
    channels: Sequence[str],     # semantic channel names
) -> MapState:
    """Fuse one camera image per env into its semantic layers: projection,
    occlusion (shadow or Bresenham) and the per-channel image fusions, all
    envs in one pass. Rebind like :func:`batched_update`."""
    with tracing.span("batch.input_image", stream=states.layers.is_cuda, maps=states.layers.shape[0]):
        return core.input_image(states, images, R, t, K, D, cfg, tuple(channels))


def shard_states(states: MapState, mesh: Mesh, axis: str = "env") -> MapState:
    """This process's part of the env axis, on its device in ``mesh``: the
    batch is cut into as many contiguous parts as the mesh axis ``axis``
    has, the last part taking the remainder. Every process calls it with the
    same global batch."""
    lo, hi = part_range(states.layers.shape[0], *axis_part(mesh, axis))
    dev = mesh_device(mesh)
    return MapState(*(x[lo:hi].to(dev) for x in states))


@torch.no_grad()
def batch_stats(states: MapState) -> Dict[str, torch.Tensor]:
    """Cross-env observability reductions (valid-cell fraction, mean height,
    drift), the batched analogue of the reference Statistics topic
    (elevation_mapping_ros.cpp:674-685). With a process group up, the sums
    behind the three means are all-reduced, so every process gets the
    fleet's values. Returns 0-d tensors."""
    valid = states.layers[:, 2] > 0.5
    frac_valid = valid.to(states.layers.dtype).mean(dim=(1, 2))
    mean_h = torch.sum(states.layers[:, 0] * valid, dim=(1, 2)) / torch.clamp(torch.sum(valid, dim=(1, 2)), min=1)
    drift = torch.abs(states.additive_mean_error)
    sums = torch.stack([
        frac_valid.sum(), mean_h.sum(), drift.sum(),
        torch.tensor(float(valid.shape[0]), dtype=frac_valid.dtype, device=frac_valid.device),
    ])
    if tdist.is_available() and tdist.is_initialized():
        tdist.all_reduce(sums)
    return {
        "frac_valid_mean": sums[0] / sums[3],
        "mean_height": sums[1] / sums[3],
        "drift_abs_mean": sums[2] / sums[3],
    }
