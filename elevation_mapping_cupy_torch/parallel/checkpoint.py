"""Checkpoint / resume for batched and env-sharded map states.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/parallel/checkpoint.py``,
without orbax. A checkpoint is a directory:

  * ``envs_<lo>_<hi>.pt`` - one per process, written with ``torch.save``:
    that process's envs [lo, hi) of every non-empty leaf, as host tensors;
  * ``checkpoint.json`` - written by process 0: the global batch, the env
    slices, and the shape and dtype of every zero-size leaf (the semantic
    stack of a map without channels), which no file holds, as the JAX
    module's ``empty_leaves.json`` does.

Under a process group every process calls :func:`save` and :func:`restore`;
a process's slice is its place in rank order (the layout of
``batch.shard_states`` along the env axis). Leaves are stored raw, so a
round trip is bit for bit. ``mapper.ElevationMap.save_checkpoint`` remains
the single-map npz of the single-robot workflow.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Optional, Tuple, Union

import torch
import torch.distributed as tdist

from ..state import STATE_FIELDS, MapState

__all__ = ["save", "restore"]

META = "checkpoint.json"


def _up() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def _barrier() -> None:
    if _up():
        tdist.barrier()


def _slices(local_batch: int) -> Tuple[List[Tuple[int, int]], int]:
    """Every process's env slice, in rank order, and this process's index."""
    if not _up():
        return [(0, local_batch)], 0
    sizes = [None] * tdist.get_world_size()
    tdist.all_gather_object(sizes, local_batch)
    starts = [sum(sizes[:i]) for i in range(len(sizes))]
    return [(s, s + b) for s, b in zip(starts, sizes)], tdist.get_rank()


def _file(path: str, lo: int, hi: int) -> str:
    return os.path.join(path, f"envs_{lo:08d}_{hi:08d}.pt")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.split(".")[-1])


def save(path: str, states: MapState, force: bool = True) -> None:
    """Write a batched MapState (this process's envs of it) to ``path``.
    ``force`` replaces a checkpoint already there; without it that raises."""
    path = os.path.abspath(path)
    slices, rank = _slices(states.layers.shape[0])
    if rank == 0:
        if os.path.exists(os.path.join(path, META)):
            if not force:
                raise FileExistsError(f"a checkpoint exists at {path}")
            for old in glob.glob(os.path.join(path, "envs_*.pt")) + [os.path.join(path, META)]:
                os.remove(old)
        os.makedirs(path, exist_ok=True)
    _barrier()
    lo, hi = slices[rank]
    stored = {name: leaf.detach().cpu() for name, leaf in zip(STATE_FIELDS, states) if leaf.numel()}
    torch.save(stored, _file(path, lo, hi))
    _barrier()
    if rank == 0:
        batch = slices[-1][1]
        empties = {
            name: [[batch, *leaf.shape[1:]], str(leaf.dtype)]
            for name, leaf in zip(STATE_FIELDS, states) if not leaf.numel()
        }
        with open(os.path.join(path, META), "w") as f:
            json.dump({"global_batch": batch, "slices": slices, "empty_leaves": empties}, f)
    _barrier()


def restore(
    path: str, template: Optional[MapState] = None, device: Union[None, str, torch.device] = None
) -> MapState:
    """Restore a checkpoint written by :func:`save`.

    With a ``template`` (e.g. ``shard_states(init_batch(cfg, B), mesh,
    "env")``) this process gets its own envs of the checkpoint, on the
    template's device with its dtypes; the processes' templates together
    must span the stored batch. Without one, the whole batch comes back on
    ``device`` (CUDA unless asked for ``"cpu"``)."""
    path = os.path.abspath(path)
    with open(os.path.join(path, META)) as f:
        meta = json.load(f)
    batch = meta["global_batch"]
    if template is None:
        from ..mapper import resolve_device

        lo, hi, dev, dtypes = 0, batch, resolve_device(device), {}
    else:
        slices, rank = _slices(template.layers.shape[0])
        if slices[-1][1] != batch:
            raise ValueError(f"the templates hold {slices[-1][1]} envs; the checkpoint holds {batch}")
        (lo, hi), dev = slices[rank], template.layers.device
        dtypes = {name: leaf.dtype for name, leaf in zip(STATE_FIELDS, template)}
    parts = {name: [] for name in STATE_FIELDS}
    for s_lo, s_hi in meta["slices"]:
        a, b = max(lo, s_lo), min(hi, s_hi)
        if a >= b:
            continue
        stored = torch.load(_file(path, s_lo, s_hi), map_location="cpu", weights_only=True)
        for name, leaf in stored.items():
            parts[name].append(leaf[a - s_lo : b - s_lo])
    leaves = []
    for name in STATE_FIELDS:
        if name in meta["empty_leaves"]:
            shape, dtype = meta["empty_leaves"][name]
            leaf = torch.zeros((hi - lo, *shape[1:]), dtype=_dtype(dtype))
        else:
            leaf = torch.cat(parts[name]) if len(parts[name]) > 1 else parts[name][0]
        leaves.append(leaf.to(dev, dtypes.get(name, leaf.dtype)))
    return MapState(*leaves)
