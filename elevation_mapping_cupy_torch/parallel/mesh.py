"""Device meshes: the layout of the processes that share a batch of maps.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/parallel/mesh.py``. The
JAX package runs one controller over every device of a host (or a pod), and
its mesh is an array of devices. PyTorch's idiom is one process per card:
each process drives its own device, and a mesh is the layout of the
processes of a ``torch.distributed`` group (a
``torch.distributed.device_mesh.DeviceMesh``, whose entries are ranks). A
process holds only its own part of a batch; a collective such as
``batch.batch_stats``'s all-reduce joins the parts.

Without a process group there is one process and one device, and
:func:`make_mesh` returns a :class:`LocalMesh` of that device, with every
axis of size 1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["LocalMesh", "make_mesh", "mesh_device", "axis_part", "part_range"]


class LocalMesh(NamedTuple):
    """The mesh of one process and one device: every axis has size 1."""

    axis_names: Tuple[str, ...]
    device: torch.device

    @property
    def shape(self) -> Tuple[int, ...]:
        return (1,) * len(self.axis_names)


Mesh = Union[LocalMesh, "dist.device_mesh.DeviceMesh"]


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def _group_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("env",),
    devices: Union[None, str, torch.device, Sequence[int]] = None,
) -> Mesh:
    """Mesh of the processes of the current group; default: one env axis
    over all of them.

    With a process group up, ``devices`` are the ranks to lay out (default:
    all of them, in order), ``shape`` must hold exactly that many, and the
    result is a ``DeviceMesh`` (every process of the group must call this).
    Without one, the mesh is this process's device: ``devices`` names it
    (``"cuda"`` unless asked for ``"cpu"``), and ``shape`` may only hold 1s.
    """
    names = tuple(axis_names)
    if not _group_up():
        from ..mapper import resolve_device

        if shape is not None and any(s != 1 for s in shape):
            raise ValueError(f"a mesh of shape {shape} needs a process group of that many processes")
        if devices is not None and not isinstance(devices, (str, torch.device)):
            devices = list(devices)
            if len(devices) != 1:
                raise ValueError(f"one process holds one device, not {len(devices)}")
            devices = devices[0]
        return LocalMesh(names, resolve_device(devices))
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    if shape is None:
        shape = (len(ranks),) + (1,) * (len(names) - 1)
    if len(shape) != len(names):
        raise ValueError(f"shape {shape} and axis names {names} differ in length")
    if torch.Size(shape).numel() != len(ranks):
        raise ValueError(f"a mesh of shape {shape} needs {torch.Size(shape).numel()} processes, not {len(ranks)}")
    return DeviceMesh(_group_device_type(), torch.tensor(ranks).reshape(shape), mesh_dim_names=names)


def mesh_device(mesh: Mesh) -> torch.device:
    """The device this process holds in ``mesh``."""
    if isinstance(mesh, LocalMesh):
        return mesh.device
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_part(mesh: Mesh, axis: str) -> Tuple[int, int]:
    """(number of parts, this process's part) along the mesh axis ``axis``:
    a batch sharded over that axis is cut into that many contiguous parts."""
    if isinstance(mesh, LocalMesh):
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
        return 1, 0
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}: {names}")
    dim = names.index(axis)
    return mesh.size(dim), mesh.get_local_rank(dim)


def part_range(n: int, parts: int, part: int) -> Tuple[int, int]:
    """[lo, hi) of part ``part`` of a batch of ``n`` cut into ``parts``
    contiguous parts, the last taking the remainder."""
    per = n // parts
    return part * per, (part + 1) * per if part < parts - 1 else n
