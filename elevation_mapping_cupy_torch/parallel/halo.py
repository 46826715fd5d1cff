"""Spatially sharded maps: halo exchanges between the processes of a mesh axis.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/parallel/halo.py``. A
map sharded over a mesh axis is cut into equal blocks of rows (or, over a
second axis, of columns); each process holds one. The JAX package's
``shard_map`` stencils take their halo rows from ring neighbours with
``lax.ppermute``. Here the exchange is written out on ``torch.distributed``:
:func:`fetch` takes any global rows from the processes that own them, so a
halo wider than a block comes from the processes beyond the neighbour.

Transport follows the group's backend: NCCL sends CUDA tensors as they
are; gloo, which has no CUDA send or receive, carries copies in host memory
(several processes that share one card run gloo). Without a process group
(a ``LocalMesh``) every axis has one process, which holds the whole map, and
nothing is exchanged.

:func:`ghost_fill` is the exchange of the sharded update step
(``spatial.py``): the ghost zone of ``g`` rows and columns around a block
that the step's stencils read.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops import stencil
from ..ops.geometry import Block
from .mesh import LocalMesh, Mesh

__all__ = [
    "Axis",
    "mesh_axis",
    "fetch",
    "halo_exchange_rows",
    "sharded_stencil",
    "sharded_uniform_smooth",
    "sharded_dilation",
    "ghost_fill",
    "wrap_edges",
]


class Axis(NamedTuple):
    """One mesh axis as this process sees it: the global ranks along it in
    order (this process's row or column of the mesh), this process's index
    among them, and the axis's process group (None for an axis of one
    process)."""

    ranks: Tuple[int, ...]
    index: int
    group: Optional[dist.ProcessGroup]

    @property
    def size(self) -> int:
        return len(self.ranks)


def mesh_axis(mesh: Optional[Mesh], name: Optional[str]) -> Axis:
    """The axis ``name`` of ``mesh``; no name (or no group) is an axis of one
    process."""
    if name is None or mesh is None or isinstance(mesh, LocalMesh):
        if mesh is not None and name is not None and name not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {name!r}: {mesh.axis_names}")
        return Axis((dist.get_rank() if dist.is_initialized() else 0,), 0, None)
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise ValueError(f"mesh has no axis {name!r}: {names}")
    dim = names.index(name)
    coord = list(mesh.get_coordinate())
    coord[dim] = slice(None)
    ranks = tuple(int(r) for r in mesh.mesh[tuple(coord)].tolist())
    return Axis(ranks, mesh.get_local_rank(dim), mesh.get_group(dim) if len(ranks) > 1 else None)


def _exchange(
    sends: Dict[int, torch.Tensor], recvs: Dict[int, torch.Size], like: torch.Tensor, axis: Axis
) -> Dict[int, torch.Tensor]:
    """Send ``sends[q]`` to the axis's process q and receive a tensor of
    shape ``recvs[q]`` from each q, all at once. Under gloo the tensors
    travel through host memory and the received ones come back to
    ``like``'s device."""
    if not sends and not recvs:
        return {}
    host = dist.get_backend(axis.group) != "nccl"
    dev = torch.device("cpu") if host else like.device
    ops, bufs = [], {}
    for q, x in sends.items():
        ops.append(dist.P2POp(dist.isend, x.to(dev).contiguous(), axis.ranks[q], axis.group))
    for q, shape in recvs.items():
        bufs[q] = torch.empty(shape, dtype=like.dtype, device=dev)
        ops.append(dist.P2POp(dist.irecv, bufs[q], axis.ranks[q], axis.group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return {q: b.to(like.device) for q, b in bufs.items()}


def fetch(
    x: torch.Tensor,
    dim: int,
    lo: int,
    want: Callable[[int], Sequence[int]],
    axis: Axis,
    extent: int,
    fill=0,
) -> torch.Tensor:
    """The global indices ``want(axis.index)`` along ``dim`` of a map of
    ``extent`` entries there, cut into ``axis.size`` equal parts, part q
    owned by the axis's process q. ``x`` holds global indices
    ``[lo, lo + x.shape[dim])`` along ``dim``, this process's part among
    them. Indices off the map take ``fill``. Every process of the axis calls
    it with the same ``want`` (a function of the process index), so each
    knows what to send where."""
    per = extent // axis.size
    me = axis.index

    def mine(idx, q):
        """(positions in idx, indices) of the entries of idx that q owns."""
        pos = [i for i, j in enumerate(idx) if q * per <= j < (q + 1) * per]
        return pos, [idx[i] for i in pos]

    wanted = list(want(me))
    shape = list(x.shape)
    shape[dim] = len(wanted)
    out = torch.full(shape, fill, dtype=x.dtype, device=x.device)

    def take(idx):
        return x.index_select(dim, torch.tensor(idx, device=x.device, dtype=torch.long) - lo)

    def put(pos, vals):
        out.index_copy_(dim, torch.tensor(pos, device=x.device, dtype=torch.long), vals)

    pos, idx = mine(wanted, me)
    if pos:
        put(pos, take(idx))
    sends, recvs, places = {}, {}, {}
    for q in range(axis.size):
        if q == me:
            continue
        _, theirs = mine(list(want(q)), me)
        if theirs:
            sends[q] = take(theirs)
        pos, _ = mine(wanted, q)
        if pos:
            shape[dim] = len(pos)
            recvs[q], places[q] = torch.Size(shape), pos
    for q, vals in _exchange(sends, recvs, x, axis).items():
        put(places[q], vals)
    return out


def _padded(axis: Axis, extent: int, halo: int) -> Callable[[int], range]:
    """Part q's rows and ``halo`` more on each side, clipped to the map."""
    per = extent // axis.size
    return lambda q: range(max(q * per - halo, 0), min((q + 1) * per + halo, extent))


def halo_exchange_rows(
    x: torch.Tensor, halo: int, mesh: Mesh, axis_name: str = "x", edge: str = "zero"
) -> torch.Tensor:
    """Pad a row-sharded block (..., h, w) with ``halo`` rows from the
    processes that own them; returns (..., h + 2*halo, w).

    Rows beyond the global map border are filled per ``edge``:
      * "zero"      - map-border semantics
      * "symmetric" - numpy's symmetric reflection of the map's own rows,
        so stencils with reflect boundaries match the unsharded op exactly
      * "neg_inf"   - neutral element for max-dilation
    """
    axis = mesh_axis(mesh, axis_name)
    h = x.shape[-2]
    extent = h * axis.size
    fills = {"zero": 0.0, "neg_inf": -float("inf"), "symmetric": 0.0}
    if edge not in fills:
        raise ValueError(f"unknown edge {edge!r}")

    def want(q):
        rows = range(q * h - halo, (q + 1) * h + halo)
        if edge != "symmetric":
            return rows
        return stencil.symmetric_index(extent, halo, torch.device("cpu"))[q * h : (q + 1) * h + 2 * halo].tolist()

    return fetch(x, x.dim() - 2, axis.index * h, want, axis, extent, fills[edge])


def sharded_stencil(
    fn: Callable[[torch.Tensor], torch.Tensor],
    mesh: Mesh,
    halo: int,
    axis_name: str = "x",
    edge: str = "zero",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Lift a (H, W) -> (H, W) stencil with radius <= halo onto a
    row-sharded map: the returned function takes this process's block and
    returns its block of the result. ``fn`` treats its input as a
    standalone block (it sees the halo rows, which are dropped after);
    ``edge`` picks the global-border fill (see :func:`halo_exchange_rows`)."""

    def block(xb: torch.Tensor) -> torch.Tensor:
        padded = halo_exchange_rows(xb, halo, mesh, axis_name, edge)
        return fn(padded)[..., halo : halo + xb.shape[-2], :]

    return block


def sharded_uniform_smooth(mesh: Mesh, passes: int = 2, size: int = 3, axis_name: str = "x"):
    """Row-sharded ``stencil.uniform_smooth`` with halo exchange. Symmetric
    edge halos keep the global border rows equal to the unsharded op's: a
    mirror-symmetric padded block stays mirror-symmetric under every
    reflect-padded smoothing pass."""
    halo = passes * (size // 2)
    return sharded_stencil(
        lambda x: stencil.uniform_smooth(x, passes=passes, size=size), mesh, halo, axis_name, edge="symmetric"
    )


def sharded_dilation(mesh: Mesh, size: int, axis_name: str = "x"):
    """Row-sharded morphological max-dilation (planning-map helper)."""

    def block(x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        p = torch.nn.functional.pad(x, (size, size, size, size), value=-float("inf"))
        out = torch.full_like(x, -float("inf"))
        for dy in range(2 * size + 1):
            for dx in range(2 * size + 1):
                out = torch.maximum(out, p[..., dy : dy + h, dx : dx + w])
        return out

    return sharded_stencil(block, mesh, size, axis_name, edge="neg_inf")


def ghost_fill(x: torch.Tensor, own: Block, rows: Axis, cols: Axis, g: int) -> Tuple[torch.Tensor, Block]:
    """This process's block ``own`` of a map, (..., h, w), with a ghost zone
    of ``g`` rows and columns around it from the processes that own them:
    rows first, then the columns of the row-padded block, so the corners
    come too. At the map's border the zone adds nothing. Returns the padded
    tensor and its block."""
    pr = _padded(rows, own.gh, g)(rows.index)
    pc = _padded(cols, own.gw, g)(cols.index)
    if rows.size > 1:
        x = fetch(x, x.dim() - 2, own.r0, _padded(rows, own.gh, g), rows, own.gh)
    if cols.size > 1:
        x = fetch(x, x.dim() - 1, own.c0, _padded(cols, own.gw, g), cols, own.gw)
    return x, Block(pr.start, pc.start, len(pr), len(pc), own.gh, own.gw)


def wrap_edges(x: torch.Tensor, block: Block, cols: Axis, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cells the flat index reaches past the map's left and right
    border from a block of ``x`` (..., h, w) (``stencil.row_wrap``'s
    (left, right)), when the map's columns are split over ``cols``: the
    processes at the two borders swap the ``size`` columns at the far
    border of the map for the block's rows, shifted by one row. Processes
    between them take part in the swap and get zeros."""
    if cols.size == 1:
        return stencil.row_wrap(x, size)
    last = cols.size - 1
    n = block.gw

    def want(q):
        return range(n - size, n) if q == 0 else range(0, size) if q == last else range(0)

    strip = fetch(x, x.dim() - 1, block.c0, want, cols, n)
    zero = torch.zeros_like(x[..., :1, :size])
    left = right = torch.zeros_like(x[..., :size])
    if cols.index == 0:      # column n - s + k of the row above
        left = torch.cat([zero, strip[..., :-1, :]], dim=-2)
    if cols.index == last:   # column k of the row below
        right = torch.cat([strip[..., 1:, :], zero], dim=-2)
    return left, right
