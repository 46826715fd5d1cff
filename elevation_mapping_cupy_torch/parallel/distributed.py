"""Multi-process runtime: process-group bring-up, pod meshes, per-process feeds.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/parallel/distributed.py``.
Where the JAX package brings up ``jax.distributed`` and lets XLA insert the
collectives, the port brings up a ``torch.distributed`` process group (NCCL
between cards, gloo on the CPU) with one process per card. Every process
owns the sensor feeds of its own envs and steps only those; the statistics
that span the fleet are all-reduced (``batch.batch_stats``).

Typical bring-up (one process per card):

    from elevation_mapping_cupy_torch.parallel import distributed as dist

    dist.initialize()                       # from JAX_COORDINATOR_ADDRESS etc.
    mesh = dist.pod_mesh(("host", "chip"))  # processes x devices per process
    states = shard_states(init_batch(cfg, global_batch), mesh, "host")
    feed = dist.HostFeed(global_batch, mesh, axis="host")
    for step in range(n_steps):
        clouds = feed.globalize(local_clouds())   # this process's envs
        states = batched_update(states, clouds, ...)

It reads the environment variables the JAX module reads
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), so a
deployment's launch scripts serve both. Without a coordinator everything is
one process: ``initialize`` returns False and ``pod_mesh`` is (1, 1).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as tdist

from .mesh import Mesh, axis_part, make_mesh, mesh_device, part_range

__all__ = ["initialize", "shutdown", "pod_mesh", "HostFeed", "process_local_slice", "process_count", "process_index"]

# how long a collective, and the bring-up itself, may wait for the others
TIMEOUT_S = 300


def _up() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def process_count() -> int:
    return tdist.get_world_size() if _up() else 1


def process_index() -> int:
    return tdist.get_rank() if _up() else 0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Union[None, str, torch.device] = None,
) -> bool:
    """Bring up the process group at ``tcp://<coordinator_address>``; returns
    True when a group is up (a group of one process too).

    Arguments not given come from ``JAX_COORDINATOR_ADDRESS`` (host:port),
    ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``; without a coordinator
    nothing is brought up and it returns whether a group was already up.
    ``device`` picks the backend: NCCL for ``"cuda"`` (the default; each
    process takes card ``process_id`` modulo the cards it sees), gloo for
    ``"cpu"``. A second call with a group up changes nothing.
    """
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if _up() or coordinator_address is None:
        return _up()
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id (or JAX_NUM_PROCESSES / JAX_PROCESS_ID)")
    from ..mapper import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    tdist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    return True


def shutdown() -> None:
    """Tear the process group down (nothing happens without one)."""
    if _up():
        tdist.destroy_process_group()


def pod_mesh(axis_names: Tuple[str, str] = ("host", "chip"), device: Union[None, str, torch.device] = None) -> Mesh:
    """(processes, devices per process) mesh: (n, 1) over a group of n
    processes, one card each; (1, 1) on this process's device without a
    group (``device`` names it then, ``"cuda"`` unless asked for ``"cpu"``)."""
    if _up():
        return make_mesh((tdist.get_world_size(), 1), axis_names)
    return make_mesh((1, 1), axis_names, devices=device)


def process_local_slice(global_batch: int) -> Tuple[int, int]:
    """[start, stop) of the env range this process owns under env sharding;
    the last process takes the remainder."""
    return part_range(global_batch, process_count(), process_index())


class HostFeed:
    """This process's part of the env axis, on its device.

    The JAX package stitches per-host data into one global array
    (``jax.make_array_from_process_local_data``). A process of the port holds
    only its own envs, so :meth:`globalize` checks that ``local`` is this
    process's slice of ``global_batch`` and puts it on the mesh's device: the
    per-process tensor is the shard.
    """

    def __init__(self, global_batch: int, mesh: Mesh, axis: str = "host"):
        self.global_batch = global_batch
        self.mesh = mesh
        self.axis = axis
        self.slice = part_range(global_batch, *axis_part(mesh, axis))
        self.device = mesh_device(mesh)

    def globalize(self, local) -> torch.Tensor:
        """local: (local_batch, ...) array or tensor -> tensor on this
        process's device."""
        x = torch.from_numpy(np.ascontiguousarray(local)) if isinstance(local, np.ndarray) else torch.as_tensor(local)
        lo, hi = self.slice
        if x.shape[0] != hi - lo:
            raise ValueError(f"this process feeds envs [{lo}, {hi}) of {self.global_batch}; got {x.shape[0]}")
        return x.to(self.device)
