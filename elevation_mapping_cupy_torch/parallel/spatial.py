"""Spatially sharded large maps: one world map partitioned across processes.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/parallel/spatial.py``.
The JAX package jits the whole update under sharding constraints and lets
GSPMD partition every stage, insert the halo exchanges and route the
map-shaped scatters to shard-local ones. PyTorch has no GSPMD, so the step
is written out here, one process per block of the map:

1. ``halo.ghost_fill`` pads this process's block with a ghost zone of
   :func:`ghost_width` rows (and columns, for 2D tiles) from the processes
   that own them: the whole step's stencil reach after its scatters;
2. ``core.update_batch_aux`` runs the whole update on the padded block, the
   association binning each (replicated) point to the block and K1
   scattering onto the block's cells, K2 marching with block bounds, the
   polar cleanup evaluating the block's cells at their global centres; the
   drift compensation's error sums, the gated march's segment counts and
   class_max's class ids are joined over the processes;
3. the ghost zone is dropped.

Map-shaped leaves of a sharded state hold this process's block: rows
``[r0, r1)`` (and with a column axis, columns ``[c0, c1)``); per-map
scalars are replicated. :func:`spatial_sharding` gives the layout and the
block; :func:`gather_spatial` puts the whole map back together on every
process. The block stays on the device of the state it was cut from, so
several processes can share one card and carry their halos over gloo.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from .. import core
from ..config import MapConfig
from ..nn.traversability import TravFilter
from ..ops.geometry import Block
from ..state import MapState
from . import halo
from .halo import Axis
from .mesh import Mesh, axis_part, part_range

__all__ = [
    "TRAV_REACH",
    "ghost_width",
    "SpatialShard",
    "SpatialSharding",
    "spatial_sharding",
    "shard_state_spatial",
    "spatial_update_pointcloud",
    "shard_states_spatial_batched",
    "batched_spatial_update_pointcloud",
    "gather_spatial",
    "spatial_move_to",
]

# cells the traversability CNN reads on each side of a cell (its 3x3
# convolution at dilation 3, nn/traversability.py)
TRAV_REACH = 3


def ghost_width(cfg: MapConfig) -> int:
    """The update's stencil reach after its scatters, in cells: the
    dilation's ``dilation_size`` plus one (its neighbours are the flat
    index's, and past a row's end that is the next row), then the
    traversability CNN's 3 on the dilated map (the normals read 1, within
    it). Every stage before the dilation is per cell."""
    return cfg.dilation_size + 1 + TRAV_REACH


def _host(x: torch.Tensor, group) -> torch.Tensor:
    """Where a collective of ``group`` takes ``x``: the card under NCCL,
    host memory under gloo."""
    return x if dist.get_backend(group) == "nccl" else x.cpu()


def _gather_axis(x: torch.Tensor, a: Axis, dim: int) -> torch.Tensor:
    """Every process of the axis's ``x``, joined along ``dim`` in order."""
    if a.group is None:
        return x
    y = _host(x, a.group).contiguous()
    parts = [torch.empty_like(y) for _ in range(a.size)]
    dist.all_gather(parts, y, group=a.group)
    return torch.cat(parts, dim=dim).to(x.device)


class SpatialShard(NamedTuple):
    """One process's part of a sharded map: the row and column axes it is
    cut over, its owned block, the padded block the step computes on (with
    the ghost zone), and the collectives over the map's processes that
    ``core.update_batch_aux`` calls."""

    rows: Axis
    cols: Axis
    own: Block
    block: Block

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the map's processes."""
        for a in (self.rows, self.cols):
            if a.group is None:
                continue
            y = _host(x, a.group).clone()
            dist.all_reduce(y, group=a.group)
            x = y.to(x.device)
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every process's ``x`` joined along axis 0."""
        return _gather_axis(_gather_axis(x, self.rows, 0), self.cols, 0)

    def owns(self, flat_idx: torch.Tensor) -> torch.Tensor:
        """Whether each cell of ``block`` (flat indices) is in ``own``."""
        rs, cs = self.block.sub(self.own)
        row, col = flat_idx // self.block.w, flat_idx % self.block.w
        return (row >= rs.start) & (row < rs.stop) & (col >= cs.start) & (col < cs.stop)

    def edges(self, x: torch.Tensor, size: int):
        """The dilation's wrapped neighbours of ``block`` (``stencil.row_wrap``)."""
        return halo.wrap_edges(x, self.block, self.cols, size)

    def pad(self, x: torch.Tensor, g: int) -> torch.Tensor:
        """The owned block (..., h, w) of a map with its ghost zone."""
        return halo.ghost_fill(x, self.own, self.rows, self.cols, g)[0]

    def crop(self, x: torch.Tensor) -> torch.Tensor:
        """The owned cells of a padded block."""
        rs, cs = self.block.sub(self.own)
        return x[..., rs, cs]


class SpatialSharding(NamedTuple):
    """The layout of a map sharded over a mesh: its rows cut over ``rows``,
    its columns over ``cols`` (an axis of one process when not split)."""

    rows: Axis
    cols: Axis

    def block(self, n: int) -> Block:
        """This process's block of an n x n map."""
        for a, what in ((self.rows, "rows"), (self.cols, "columns")):
            if n % a.size:
                raise ValueError(
                    f"spatial sharding needs the map extent ({n} = cell_n) divisible by the {a.size} "
                    f"processes of the {what}' mesh axis; pick map_length so round(map_length/resolution)+2 "
                    f"is a multiple of {a.size}"
                )
        h, w = n // self.rows.size, n // self.cols.size
        return Block(self.rows.index * h, self.cols.index * w, h, w, n, n)

    def shard(self, n: int, g: int) -> SpatialShard:
        """The step's shard of an n x n map with a ghost zone of g cells."""
        own = self.block(n)
        r0, c0 = max(own.r0 - g, 0), max(own.c0 - g, 0)
        r1, c1 = min(own.r0 + own.h + g, n), min(own.c0 + own.w + g, n)
        return SpatialShard(self.rows, self.cols, own, Block(r0, c0, r1 - r0, c1 - c0, n, n))


def spatial_sharding(mesh: Mesh, axis: str = "x", col_axis: Optional[str] = None) -> SpatialSharding:
    """Row (or, with ``col_axis``, 2D-tile) layout of (L, H, W) layer stacks
    over ``mesh``; ``.block(cell_n)`` is this process's block."""
    return SpatialSharding(halo.mesh_axis(mesh, axis), halo.mesh_axis(mesh, col_axis))


def _map_leaves(state: MapState, fn) -> MapState:
    """``fn`` applied to the map-shaped fields (layers, normal, semantic,
    sem_new, id_max); the per-map scalars stay as they are."""
    return state._replace(
        layers=fn(state.layers), normal=fn(state.normal), semantic=fn(state.semantic),
        sem_new=fn(state.sem_new), id_max=fn(state.id_max),
    )


def shard_state_spatial(
    state: MapState, mesh: Mesh, axis: str = "x", col_axis: Optional[str] = None
) -> MapState:
    """This process's block of one (unbatched, or batched) map state: the
    map-shaped fields cut to its rows (and with ``col_axis``, columns);
    per-map scalars stay replicated. Every process calls it with the same
    state. 2D tiling is the pod-scale layout: row-only sharding over many
    processes degenerates to slivers whose halos dominate."""
    b = spatial_sharding(mesh, axis, col_axis).block(state.layers.shape[-1])
    return _map_leaves(state, lambda x: x[..., b.r0 : b.r0 + b.h, b.c0 : b.c0 + b.w].clone())


def gather_spatial(
    state: MapState,
    mesh: Mesh,
    axis: str = "x",
    col_axis: Optional[str] = None,
    env_axis: Optional[str] = None,
) -> MapState:
    """The whole map (or with ``env_axis``, the whole batch of maps) on
    every process, from each process's block: what ``np.asarray`` of a
    sharded array gives in the JAX package."""
    lay = spatial_sharding(mesh, axis, col_axis)
    out = _map_leaves(state, lambda x: _gather_axis(_gather_axis(x, lay.rows, x.dim() - 2), lay.cols, x.dim() - 1))
    if env_axis is not None:
        env = halo.mesh_axis(mesh, env_axis)
        out = MapState(*(_gather_axis(x, env, 0) for x in out))
    return out


def _pad_state(state: MapState, shard: SpatialShard, g: int) -> MapState:
    """The owned blocks of a state's map-shaped fields with their ghost
    zone: the float fields in one exchange, the class ids in another."""
    floats = [state.layers, state.normal, state.semantic, state.sem_new]
    sizes = [x.shape[-3] for x in floats]
    parts = shard.pad(torch.cat(floats, dim=-3), g).split(sizes, dim=-3)
    ids = state.id_max
    ids = shard.pad(ids, g) if ids.numel() else ids.new_zeros(*ids.shape[:-2], shard.block.h, shard.block.w)
    return state._replace(layers=parts[0], normal=parts[1], semantic=parts[2], sem_new=parts[3], id_max=ids)


def _step(state, points, pad_mask, R, t, pn, on, weights, cfg, channels, lay: SpatialSharding):
    """One sharded update of a batch of maps (B, ...) on this process's
    block: ghost fill, the core update on the padded block, the ghost zone
    dropped."""
    g = ghost_width(cfg)
    shard = lay.shard(cfg.cell_n, g)
    if shard.block == shard.own:   # one process holds the whole map
        return core.update_batch_aux(state, points, pad_mask, R, t, pn, on, weights, cfg, channels)[0]
    out, _ = core.update_batch_aux(_pad_state(state, shard, g), points, pad_mask, R, t, pn, on, weights, cfg,
                                   channels, shard=shard)
    return _map_leaves(out, shard.crop)


def spatial_update_pointcloud(
    mesh: Mesh,
    cfg: MapConfig,
    axis: str = "x",
    channels: Sequence[str] = (),
    col_axis: Optional[str] = None,
):
    """The update step of a map sharded over ``mesh``:
    ``step(state, points, pad_mask, R, t, position_noise,
    orientation_noise, weights)`` takes and returns this process's block
    (``shard_state_spatial``). Points are replicated: every process passes
    the whole cloud and keeps the cells it owns. Pass ``channels`` (as for
    ``core.update_pointcloud_semantic``) to fuse semantic layers too; with
    ``col_axis`` the map is tiled over a 2D mesh. Every process of the mesh
    calls the step together. Rebind (``state = step(state, ...)``), as with
    the JAX step, which donates its input."""
    lay = spatial_sharding(mesh, axis, col_axis)
    channels = tuple(channels)

    @torch.no_grad()
    def step(state: MapState, points, pad_mask, R, t, position_noise, orientation_noise, weights: TravFilter):
        one = MapState(*(x[None] for x in state))
        out = _step(one, points[None], pad_mask[None], R[None], t[None], position_noise, orientation_noise,
                    weights, cfg, channels, lay)
        return MapState(*(x[0] for x in out))

    return step


def shard_states_spatial_batched(
    states: MapState,
    mesh: Mesh,
    env_axis: str = "env",
    axis: str = "x",
    col_axis: Optional[str] = None,
) -> MapState:
    """This process's part of a BATCH of spatially sharded maps over an
    (env, rows[, cols]) mesh: its contiguous part of the batch axis (which
    must divide by the env axis) and, of each map, its block."""
    b = states.layers.shape[0]
    parts, part = axis_part(mesh, env_axis)
    if b % parts:
        raise ValueError(f"batch {b} not divisible by mesh axis {env_axis!r} ({parts})")
    lo, hi = part_range(b, parts, part)
    local = MapState(*(x[lo:hi] for x in states))
    return shard_state_spatial(local, mesh, axis, col_axis)


def batched_spatial_update_pointcloud(
    mesh: Mesh,
    cfg: MapConfig,
    env_axis: str = "env",
    axis: str = "x",
    channels: Sequence[str] = (),
    col_axis: Optional[str] = None,
):
    """Update step for a BATCH of spatially sharded maps on an
    (env, rows[, cols]) mesh: env batching composed with spatial sharding.
    ``step(states, points, pad_mask, R, t, position_noise,
    orientation_noise, weights)`` takes this process's maps
    (``shard_states_spatial_batched``) and their inputs: points (B, N, 3[+C]),
    pad_mask (B, N), R (B, 3, 3), t (B, 3), noises (B,), B this process's
    part of the batch, as ``batch.batched_update`` takes them. Every stage
    runs once over the batch on the padded blocks, K1 once per scatter
    stage for all maps. The ``env_axis`` is accepted for the JAX API: the
    maps of a process are its own, and only the spatial axes exchange."""
    axis_part(mesh, env_axis)  # the mesh must have it
    lay = spatial_sharding(mesh, axis, col_axis)
    channels = tuple(channels)

    @torch.no_grad()
    def step(states: MapState, points, pad_mask, R, t, position_noise, orientation_noise, weights: TravFilter):
        return _step(states, points, pad_mask, R, t, position_noise, orientation_noise, weights, cfg, channels, lay)

    return step


def _shift_axis(x: torch.Tensor, s: int, a: Axis, lo: int, extent: int, dim: int) -> torch.Tensor:
    """Entry i of ``x`` along ``dim`` (global ``lo + i``) takes the map's
    entry ``lo + i - s``, from the process that owns it; entries off the
    map take 0."""
    per = x.shape[dim]
    return halo.fetch(x, dim, lo, lambda q: range(q * per - s, (q + 1) * per - s), a, extent)


@torch.no_grad()
def spatial_move_to(
    state: MapState,
    position: torch.Tensor,
    R: torch.Tensor,
    cfg: MapConfig,
    mesh: Mesh,
    axis: str = "x",
    col_axis: Optional[str] = None,
) -> MapState:
    """``core.move_to`` of a sharded map (one map, or a batch with (B, 3)
    positions as ``batch.batched_move_to``): the cells a shift brings into
    this process's block come from the processes that own them, rows first,
    then columns, with the same reset of revealed cells. The whole-cell
    shift is read back to the host once per move (per map of a batch); the
    unsharded ``core.move_to`` reads nothing back."""
    lay = spatial_sharding(mesh, axis, col_axis)
    own = lay.block(cfg.cell_n)
    n = cfg.cell_n
    dev = state.layers.device

    def shift_xy(st: MapState, s0: torch.Tensor, s1: torch.Tensor, cfg: MapConfig) -> MapState:
        shifts = torch.stack([s0, s1], dim=-1).reshape(-1, 2).to(torch.int64).tolist()
        batched = s0.dim() > 0
        maps = [MapState(*(x[b] for x in st)) for b in range(len(shifts))] if batched else [st]
        out = []
        for one, (a, c) in zip(maps, shifts):
            def roll(x, a=a, c=c):
                if x.numel() == 0:
                    return x
                x = _shift_axis(x, a, lay.rows, own.r0, n, x.dim() - 2)
                return _shift_axis(x, c, lay.cols, own.c0, n, x.dim() - 1)

            rows = own.rows(dev) - a
            cols = own.cols(dev) - c
            revealed = (rows < 0) | (rows >= n) | (cols < 0) | (cols >= n)
            out.append(core.shift_cells(one, roll, revealed, cfg))
        return MapState(*(torch.stack(f) for f in zip(*out))) if batched else out[0]

    return core.move_to(state, position, R, cfg, shift_xy=shift_xy)
